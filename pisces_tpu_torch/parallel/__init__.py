"""Multi-device execution of the port (the in-process device mesh)."""
