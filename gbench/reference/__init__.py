"""Plain PyTorch references that decide `correct`. They work from the
benchmark's own canonical arrays (`gbench.graphs.Graph`) and import nothing
of the program."""
