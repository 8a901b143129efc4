"""Command-line tools of the port, run as `python -m
graphblast_tpu_torch.tools.<name>`: `gen_rmat_cache` builds RMAT cache
files ahead, `mtx_ingest_check` round-trips a generated graph through a
MatrixMarket file and both parsers."""
