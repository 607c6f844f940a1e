"""Diagnostics ported so far: bulk ESS and split R-hat, monolithic and
chain-chunked."""

from mcmc_tpu_torch.diagnostics.rhat_ess import ess_bulk, split_rhat
from mcmc_tpu_torch.diagnostics.streaming import (ess_bulk_chunked,
                                                  split_rhat_chunked)

__all__ = ["ess_bulk", "split_rhat", "ess_bulk_chunked", "split_rhat_chunked"]
