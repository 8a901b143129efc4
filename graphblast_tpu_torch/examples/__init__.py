"""Example drivers of the reference's CLI contract (counterparts of the
JAX package's examples/): parse, load, CPU golden, warm-up, verify, time.
Run one as `python -m graphblast_tpu_torch.examples.gbfs <graph> [flags]`;
`--device cpu` runs the kernels' plain versions."""
