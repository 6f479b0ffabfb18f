"""repro_torch — the DYVERSE reproduction on PyTorch and CUDA.

A port of the JAX package ``repro`` (which stays the reference) laid out
module for module like it: ``repro_torch.X`` is the counterpart of
``repro.X``. Host-side logic (controller, monitor, quota, forecast, the
numpy engines, federation, scenarios, observability) is carried over as
plain numpy with the same semantics; what ran on the TPU runs here as
hand-written CUDA kernels (:mod:`repro_torch.kernels.fleet`, sources in
``csrc/``) behind ``engine="torch"``.
"""
