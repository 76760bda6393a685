"""Host-side utilities of the torch port."""
