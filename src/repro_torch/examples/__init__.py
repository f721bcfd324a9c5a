"""The port's counterparts of the reference's ``examples/`` scripts: the
training CLI, the multi-scene service demo and the quickstart, each run as
``python -m repro_torch.examples.<name>`` and on the card unless
``--device cpu`` (``device="cpu"``) is given."""
