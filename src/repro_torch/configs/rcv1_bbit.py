"""The paper's own configuration: b-bit hashed linear model on the
expanded rcv1 (200 GB → n·b·k bits); the port's copy of
``repro/configs/rcv1_bbit.py`` over its ``BBitLinearConfig``.

Production settings follow the paper's best-performing regime
(k=500, b=16 — Figures 1-4) over the D≈2^30 expanded feature space,
trained with LR (Eq. 9) or L2-SVM (Eq. 8) at LIBLINEAR C∈[1e-3,1e2].
At b=16 the packed archive is written by B1 (minwise encode and pack,
any b in [1, 16]) and the table (k, 65,536, 1) is read by B7 and B8.
"""
import dataclasses

from repro_torch.models.linear import BBitLinearConfig


@dataclasses.dataclass(frozen=True)
class PaperConfig:
    name: str = "rcv1-bbit"
    k: int = 500
    b: int = 16
    n_classes: int = 2
    loss: str = "logistic"       # or 'squared_hinge' (Eq. 8)
    C: float = 1.0
    ambient_dim: int = 1 << 30   # expanded rcv1: D ≈ 1.01e9
    global_batch: int = 65536    # examples per distributed step
    hash_family: str = "multiply_shift"
    scheme: str = "minwise"      # see configs.rcv1_oph for the OPH twin
    seed: int = 0

    def linear_config(self) -> BBitLinearConfig:
        return BBitLinearConfig(k=self.k, b=self.b,
                                n_classes=self.n_classes)


CONFIG = PaperConfig()
