"""Loss stacks of the port."""
