"""Exporters of the port."""
