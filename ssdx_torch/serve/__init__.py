"""HTTP demo app and micro-batcher of the PyTorch port."""
