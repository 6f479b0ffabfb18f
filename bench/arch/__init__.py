"""The program's side of each architecture, one file a configuration's
``"arch"``, found by :func:`bench.modules.program`.

Each file defines ``program_config(cfg)`` (the port's ``ModelConfig`` of
a configuration file), ``hand_in(params, w, cfg)`` (the benchmark's
weights, :mod:`bench.reference.weights`, copied into the program's),
``prefill_flops(cfg, S)`` and ``decode_flops(cfg, lengths)`` (the model
FLOPs that ``mfu`` counts) and ``attention_layers(cfg)`` (how many
layers run K4 in a prefill and K5 in a decode step). Beside the
harness's engine and recorder set-up, these files are the only
benchmark code that knows the port's model layout. What they share,
such as :func:`put`, lives here, so that no architecture's file reads
another's."""
from __future__ import annotations


def put(dst, src) -> None:
    """Copy one leaf into the program's weight of the same shape."""
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"weight of {tuple(dst.shape)} given "
                         f"{tuple(src.shape)}")
    dst.data.copy_(src)
