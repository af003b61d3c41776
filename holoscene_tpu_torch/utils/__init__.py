"""Host-side utilities of the port (numpy only): mesh I/O, marching
tetrahedra, image metrics, the JSONL metrics log."""
