"""The drivers: one module a kind of training step, named by a
configuration's `driver` key."""
