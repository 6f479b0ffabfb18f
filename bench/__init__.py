"""The benchmark of ``repro_torch`` on one NVIDIA H100: DYVERSE-scaled
LLM tenants in the multi-tenant serving engine (``python3 bench/run.py``)."""
