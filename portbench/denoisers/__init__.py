"""Program-side denoiser modules: each builds the program's denoiser of a
configuration."""
