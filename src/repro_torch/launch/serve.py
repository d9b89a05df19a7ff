"""Serving launcher: the open-loop bench lane over FilterServeEngine.

  PYTHONPATH=src python -m repro_torch.launch.serve --duration 20 --rate 40

Thin alias for ``repro_torch.serving.bench`` (the Poisson arrival
driver), as the reference's ``launch/serve.py``, so the launch namespace
keeps one entry point per lane; every flag is documented there.
"""
from __future__ import annotations

import sys

from repro_torch.serving.bench import main

if __name__ == "__main__":
    sys.exit(main())
