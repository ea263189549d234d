"""The port's examples, each a script with ``--device`` (default the card):
``python -m repro_torch.examples.<name> [--device cpu]``."""
