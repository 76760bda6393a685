"""Environment families of the torch port."""
