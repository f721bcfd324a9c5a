"""The port's counterparts of the reference's ``examples/`` scripts: the
training CLI, the multi-scene service demo, the quickstart, the small-LM
pretraining loop (`lm_pretrain`) and the batched LM serving loop
(`serve_lm`), each run as ``python -m repro_torch.examples.<name>`` and on
the card unless ``--device cpu`` (``device="cpu"``) is given."""
