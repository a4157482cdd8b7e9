"""Entry points of the port (port of ``repro.launch``): the trainer."""
