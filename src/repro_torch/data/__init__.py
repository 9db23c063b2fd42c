"""Synthetic data for the LM training CLI."""
from repro_torch.data.synthetic import SyntheticLM, client_lm_datasets, make_lm_batches, make_lm_data

__all__ = ["SyntheticLM", "client_lm_datasets", "make_lm_batches", "make_lm_data"]
