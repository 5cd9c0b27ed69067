"""Device selection and environment knobs of the PyTorch/CUDA port."""
