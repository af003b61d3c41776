"""Stage runners and CLIs of the port."""
