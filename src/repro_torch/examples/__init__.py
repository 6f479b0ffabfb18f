"""The JAX package's five examples (``examples/*.py``) as the port's entry
points, each ``python -m repro_torch.examples.<name> [--device cpu]``
with ``main(argv=None)``: ``quickstart``, ``train_100m``,
``elastic_restart``, ``multitenant_serve`` and ``federation_demo``. They
run on the card unless ``--device cpu`` is given; each keeps its
printout the reference's, and ``examples/*.py`` stay the reference's."""
