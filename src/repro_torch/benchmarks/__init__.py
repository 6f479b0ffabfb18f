"""The port's benchmarks: the section runner (:mod:`.run`), the campaign
CLI (:mod:`.campaign`) and the sections they run (:mod:`.paper_figs`,
:mod:`.federation_bench`, :mod:`.serving_bench`). They write only
``BENCH_torch*.json`` files.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --quick --device cpu
    PYTHONPATH=src python -m repro_torch.benchmarks.campaign --quick \\
        --device cpu
"""
