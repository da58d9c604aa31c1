"""The paper's own experimental workload (§4): l1-regularized logistic
regression on rcv1-like / MNIST-like data (synthetic stand-ins offline).
(lam1, lam2) follow the paper: (1e-5, 1e-4) rcv1, (1e-3, 1e-4) MNIST."""
import dataclasses

from repro_torch.core.problems import LogRegProblem, make_logreg


@dataclasses.dataclass(frozen=True)
class PaperWorkload:
    name: str
    n_samples: int
    dim: int
    n_workers: int
    sparse_like: bool
    lam1: float
    lam2: float
    m_blocks: int = 20

    def build(self, seed: int = 0, device=None) -> LogRegProblem:
        return make_logreg(self.n_samples, self.dim, self.n_workers,
                           sparse_like=self.sparse_like, lam1=self.lam1,
                           lam2=self.lam2, seed=seed, device=device)


RCV1_LIKE = PaperWorkload("rcv1-like", n_samples=4000, dim=800, n_workers=10,
                          sparse_like=True, lam1=1e-5, lam2=1e-4)
MNIST_LIKE = PaperWorkload("mnist-like", n_samples=4000, dim=784, n_workers=10,
                           sparse_like=False, lam1=1e-3, lam2=1e-4)
