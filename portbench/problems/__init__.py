"""Program-side problem modules: each makes a configuration's inputs from the
seed (plain PyTorch, on the device, the benchmark's own) and hands them to
the program as its problem type."""
