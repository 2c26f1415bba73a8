"""The examples of ``repro`` (``examples/quickstart.py``,
``examples/elastic_restart.py`` and ``examples/serve_bravo.py``) on the
port, run as modules:

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.elastic_restart [--device cpu]
    python -m repro_torch.examples.serve_bravo [--device cpu]
"""
