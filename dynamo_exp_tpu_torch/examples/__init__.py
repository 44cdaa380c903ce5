"""Example service graphs of the port (counterpart of ``examples/``)."""
