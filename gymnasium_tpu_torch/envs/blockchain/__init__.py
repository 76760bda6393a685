"""The blockchain CPD game as a functional env."""

from gymnasium_tpu_torch.envs.blockchain.cpd_functional import BlockchainCPDFunctional, CPDParams

__all__ = ["BlockchainCPDFunctional", "CPDParams"]
