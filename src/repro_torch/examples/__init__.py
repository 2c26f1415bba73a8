"""The training examples of ``repro`` (``examples/quickstart.py`` and
``examples/elastic_restart.py``) on the port, run as modules:

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.elastic_restart [--device cpu]
"""
