"""The JAX package's four example flows on the port, each a module run as
``python -m repro_torch.examples.<name> [...] [--device cpu]`` (the card
by default): ``quickstart``, ``hgnn_train_acm``, ``restructure_demo`` and
``lm_serve_demo``.  Each module's ``main(argv)`` runs its flow, prints what
the reference example prints, and returns the flow's products."""
