"""Known-bad fixture for HOST001: a host ``if`` / ``while`` on a tensor's
value inside a solver loop.

The reference's JIT002 fixture branches in Python on a tracer inside a
scan body.  In the port the loop runs on the host and the tensor lives on
the card, so such a test waits for the stream on every event.  The
``is None`` test and the metadata reads are exempt, as in the reference
-- included below to prove the exemptions hold.

Never imported or executed.
"""
import torch


def run(x0: torch.Tensor, grads: torch.Tensor, faults=None) -> torch.Tensor:
    x = x0.clone()
    for k in range(grads.shape[0]):
        g = grads[k]
        if g.norm() > 1.0:  # BAD: a stream wait per event
            g = g / g.norm()
        if faults is not None and x.shape[0] > 1:  # OK: structure, metadata
            g = torch.where(torch.isfinite(g), g, 0.0)
        x = x - 0.1 * g
    return x


def drain(residual: torch.Tensor, steps: int) -> torch.Tensor:
    total = torch.zeros_like(residual)
    for _ in range(steps):
        while total.sum() < 1.0:  # BAD: a stream wait per pass
            total = total + residual
    return total
