"""The paper's own application config: Riemannian similarity learning (RSL).

Learns W in R^{d1 x d2} with rank(W) = r between two data domains (the paper
uses MNIST d1=784 and USPS d2=256); scaled variants up to d1=d2=10000
(W = 1e8 params) are used by the end-to-end driver
(``python -m repro_torch.launch.train_rsl``).  Counterpart of
``repro.configs.paper_rsl``, field for field.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class RSLConfig:
    d1: int = 784              # MNIST pixel dim
    d2: int = 256              # USPS pixel dim
    rank: int = 5              # manifold rank (paper: 5)
    batch_size: int = 64
    lr: float = 1e-2
    weight_decay: float = 1e-4  # lambda in Alg 4 line 6
    steps: int = 2000
    fsvd_iters: int = 20       # "lower iter" = 20, "higher iter" = 35 (paper Fig 2)
    loss: str = "hinge"        # hinge | logistic
    seed: int = 0


CONFIG = RSLConfig()
CONFIG_100M = RSLConfig(d1=10000, d2=10000, rank=5, batch_size=32, steps=300,
                        fsvd_iters=20)
