"""Physics engines of the torch port."""
