"""Seeded-bug fixtures for the port's kernel verifier: the CUDA ring's
schedule model (``repro_torch.analysis.ir.RingModel``) with EXACTLY ONE
invariant deliberately broken — the regression corpus that pins each pass
to the bug class it exists for, under the names of the reference's
corpus (``tests/analysis_fixtures``) and one more:

``stale_guard``      the producer drops the plane from the box origin
                     (its TMA coordinate z is 0): every item of a later
                     plane finds plane 0's window in its stage
                     -> ``bank_hazard`` (stale)
``unpaired_start``   the producer's loop runs one item past the block's
                     last: that box lies past the last plane (TMA fills it
                     with zeros) and no consumer ever waits for it
                     -> ``dma_pairing`` (never waited)
``premature_reuse``  the empty barriers count one arrival too few, so a
                     stage is refilled before its last consumer warp is
                     done with it -> ``bank_hazard`` (rewritten while)
``widen_mac``        the int8 stream is widened to float32 at the MAC
                     input instead of the int32 accumulator
                     -> ``width_lint`` (floating)
``smem_over``        the whole bank of 256 w13 float32 filters in one
                     launch's coefficient file, past a block's shared
                     memory -> ``vmem_budget``

``build(name)`` returns ``(plan, verify_kwargs)`` ready for
``analysis.verify_kernel(plan, **verify_kwargs)``; ``FIXTURES[name]``
carries the pass each one must be flagged by (and no other).
"""
import dataclasses

from repro_torch.analysis.ir import RingModel
from repro_torch.core.border_spec import BorderSpec
from repro_torch.kernels.filter2d import halo


class StaleGuard(RingModel):
    def load_box(self, item, m, ywin0, bx0):
        return super().load_box(item, 0, ywin0, bx0)


class UnpairedStart(RingModel):
    def producer_items(self, n_items):
        return n_items + 1


class PrematureReuse(RingModel):
    def empty_arrivals(self):
        return self.contract.arrivals - 1


class WidenMac(RingModel):
    def read_acc_kind(self):
        return "float32"


class SmemOver(RingModel):
    def chunks(self):
        return ((0, self.contract.num_filters),)


def _schedule(model):
    def run(contract, geometry, plan, M, blocks):
        if model is SmemOver:
            contract = dataclasses.replace(
                contract, chunks=((0, contract.num_filters),))
        return model(contract, geometry, plan, M, blocks).run()
    return run


FIXTURES = {
    "stale_guard": dict(expect_pass="bank_hazard", expect_msg="stale",
                        model=StaleGuard, dtype="float32", M=3,
                        num_filters=2),
    "unpaired_start": dict(expect_pass="dma_pairing",
                           expect_msg="never waited", model=UnpairedStart,
                           dtype="float32", M=2, num_filters=1),
    "premature_reuse": dict(expect_pass="bank_hazard",
                            expect_msg="rewritten while",
                            model=PrematureReuse, dtype="float32", M=2,
                            num_filters=2),
    "widen_mac": dict(expect_pass="width_lint", expect_msg="floating",
                      model=WidenMac, dtype="int8", M=2, num_filters=1),
    "smem_over": dict(expect_pass="vmem_budget",
                      expect_msg="exceeds the per-block shared memory",
                      model=SmemOver, dtype="float32", M=1,
                      num_filters=256, window=13),
}


def build(name: str):
    """``(plan, verify_kwargs)`` of fixture ``name``: a [M, 64, 300] frame
    (2 strips x 3 tiles a plane at float32) under mirror, on 2 blocks."""
    cfg = FIXTURES[name]
    w = cfg.get("window", 5)
    plan = halo.make_plan(64, 300, w, BorderSpec("mirror"), 64, 300,
                          dtype=cfg["dtype"])
    return plan, dict(num_filters=cfg["num_filters"], dtype=cfg["dtype"],
                      M=cfg["M"], loader="tma", blocks=2,
                      schedule=_schedule(cfg["model"]), key=name)
