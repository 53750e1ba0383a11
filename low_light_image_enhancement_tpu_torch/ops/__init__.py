"""Plain PyTorch ops: normalization, filters, denoise, curves."""
