"""The port's examples: counterparts of the JAX package's ``examples/``, run
as ``python -m repro_torch.examples.<name>`` (on the card unless ``--device
cpu`` is given, wherever they run a model)."""
