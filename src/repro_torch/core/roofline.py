"""Three-term roofline model over a device tree (a copy of
``repro.core.roofline``, for the H100).

    compute term    = flops_per_device      / peak_FLOP/s_per_chip
    memory term     = bytes_per_device      / HBM_bw_per_chip
    collective term = coll_bytes_per_device / (links_per_chip * link_bw)

The JAX package takes the flops and bytes from XLA's ``cost_analysis`` and
its device tree; the port has no compiler cost model, so
:func:`report_from_tree` takes them from the device tree of one profiled step
(``core/device_tree.py``) and, on the card, the step's measured time beside
the bound. The step-time estimate is the max of the three terms (perfect
overlap); the dominant term is the one to work on. Field names are the JAX
package's, so ``core/planes.py`` reads a spec of either package unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .calltree import CallTree


@dataclass(frozen=True)
class HardwareSpec:
    """One accelerator's peak rates. The link fields keep the JAX package's
    names (``ici_*``): on the H100 they are NVLink 4's, which no single-card
    path uses."""

    name: str
    peak_flops: float  # dense bf16 FLOP/s per chip
    hbm_bw: float  # bytes/s per chip
    ici_link_bw: float  # bytes/s per link and direction
    ici_links: int  # links per chip
    hbm_bytes: float  # capacity, for fit checks


# H100 SXM5 data sheet: 989 TFLOP/s dense bf16 on the tensor cores (f32
# outside them runs at 67 TFLOP/s, so an f32 product's compute term reads
# low), 3.35 TB/s of HBM3, 80 GB; NVLink 4: 18 links of 25 GB/s a direction.
H100 = HardwareSpec("h100-sxm5-80gb", peak_flops=989e12, hbm_bw=3.35e12, ici_link_bw=25e9, ici_links=18,
                    hbm_bytes=80e9)


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_by_kind: dict[str, float] = field(default_factory=dict)
    model_flops_global: float = 0.0  # 6*N*D (dense) or 6*N_active*D (MoE)
    per_device_hbm_peak: float = 0.0  # torch.cuda.max_memory_allocated, where measured
    hw: HardwareSpec = H100
    measured_step_s: float = 0.0  # the profiled step's wall on the card; 0 where not measured

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / (self.hw.ici_links * self.hw.ici_link_bw)

    @property
    def t_step(self) -> float:
        """Perfect-overlap lower bound on step time."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory, "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (tree FLOPs * chips): how much counted compute is useful.

        < 1 means remat/redundancy waste; > 1 means the count missed
        something (e.g. attention FLOPs not in the 6ND napkin model)."""
        total = self.flops_per_device * self.chips
        return self.model_flops_global / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline bound."""
        if self.t_step <= 0 or self.chips == 0:
            return 0.0
        return self.model_flops_global / (self.t_step * self.chips * self.hw.peak_flops)

    @property
    def hw_util(self) -> float:
        """Fraction of roofline the dominant resource reaches if the other two
        overlap perfectly: compute-term / step-time when compute-bound, etc."""
        if self.t_step <= 0:
            return 0.0
        return self.t_compute / self.t_step

    @property
    def bound_share(self) -> float:
        """The roofline bound as a share of the measured step (0 where not measured)."""
        return self.t_step / self.measured_step_s if self.measured_step_s > 0 else 0.0

    def fits_hbm(self) -> bool:
        return self.per_device_hbm_peak <= self.hw.hbm_bytes

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "t_step_s": self.t_step,
            "dominant": self.dominant,
            "model_flops": self.model_flops_global,
            "hlo_flops_per_dev": self.flops_per_device,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu,
            "hbm_peak_bytes": self.per_device_hbm_peak,
            "fits_hbm": self.fits_hbm(),
            "measured_step_s": self.measured_step_s,
            "bound_share": self.bound_share,
            **{f"coll_{k}": v for k, v in self.coll_by_kind.items()},
        }


def report_from_tree(
    *,
    arch: str,
    shape: str,
    device_tree: CallTree,
    mesh: str = "1",
    chips: int = 1,
    measured_step_s: float = 0.0,
    hbm_peak_bytes: float = 0.0,
    model_flops_global: float = 0.0,
    hw: HardwareSpec = H100,
) -> RooflineReport:
    """The counterpart of the JAX package's ``report_from_artifacts``: the
    tree's root totals in place of XLA's cost analysis (the profiled step
    ran every loop trip, so nothing needs a trip count)."""
    coll_by_kind = {k.split("::", 1)[1]: v for k, v in device_tree.root.metrics.items()
                    if k.startswith("coll_bytes::") and v}
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh,
        chips=chips,
        flops_per_device=device_tree.total("flops"),
        bytes_per_device=device_tree.total("bytes"),
        coll_bytes_per_device=device_tree.total("coll_bytes"),
        coll_by_kind=coll_by_kind,
        model_flops_global=model_flops_global,
        per_device_hbm_peak=hbm_peak_bytes,
        hw=hw,
        measured_step_s=measured_step_s,
    )
