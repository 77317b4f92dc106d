"""The JAX package's ``examples/`` on the port, run as modules from the
repository root, e.g. ``python3 -m chad_tsdf_tpu_torch.examples.demo_sphere``.
Each has its JAX counterpart's flags, defaults, output and exit codes;
``--cpu`` runs on the CPU (``device="cpu"``), else on the card."""
