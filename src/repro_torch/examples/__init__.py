"""The paper's examples on the port (``examples/`` of the repository, on
``repro_torch``): ``quickstart``, ``resize_images``, ``tune_tiles`` and
``serve_lm``. Each runs as ``python -m repro_torch.examples.<name>`` and
takes ``--device`` (default ``cuda``; ``cpu`` runs the plain versions)."""
