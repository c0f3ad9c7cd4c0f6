"""Analytical model of the ULEEN inference accelerator (paper §III-C, §V);
a copy of `repro/core/hwmodel.py` (numpy only), kept in the port so that
the port imports nothing of the JAX package.

Its outputs model the paper's FPGA (Xilinx Z7045) and ASIC (FreePDK45)
accelerators, calibrated against the paper's published design points.
They are not measurements of the GPU the port runs on: a caller that
prints them labels them as the FPGA/ASIC model.

No FPGA/ASIC tools are at hand, so Tables II/III are reproduced
structurally: the pipelined accelerator's throughput is bus-bound,

    II (cycles) = ceil(compressed_input_bits / bus_width)
    throughput  = f_clk / II

which matches every published ULEEN row exactly (e.g. ULN-S on the Z7045:
784 px x 2b = 1568b / 112b = 14 cycles -> 200 MHz / 14 = 14,286 kIPS;
ULN-L ASIC: 784 x 3b = 2352b / 192b = 13 cycles -> 500 MHz / 13 = 38,462
kIPS). Latency adds the pipeline depth (hash accumulation + lookup + adder
trees + argmax). Power/area use per-op energies calibrated against the six
published design points, and extrapolate to *our* trained models'
structural counts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Platform:
    name: str
    bus_bits: int
    freq_hz: float
    # calibrated per-op energies (J); populated by calibrate()
    e_hash: float = 0.0       # per hash-unit op
    e_lookup: float = 0.0     # per table lookup bit-read
    e_add: float = 0.0        # per popcount/adder-tree add
    e_io: float = 0.0         # per input bit moved
    e_leak: float = 0.0       # W per table bit (leakage + clock tree ~ area)
    p_static: float = 0.0     # W
    a_table: float = 0.0      # mm^2 per table bit (ASIC only)
    a_logic: float = 0.0      # mm^2 per logic op (ASIC only)


FPGA_Z7045 = Platform("xilinx-z7045", bus_bits=112, freq_hz=200e6)
FPGA_Z7045_SLOW = Platform("xilinx-z7045@85MHz", bus_bits=112, freq_hz=85e6)
ASIC_45NM = Platform("freepdk45", bus_bits=192, freq_hz=500e6)


@dataclasses.dataclass(frozen=True)
class ModelCounts:
    """Structural per-inference counts, derived from a trained model."""
    input_features: int
    bits_per_input: int
    hash_ops: int             # filters x k, summed over submodels
    lookups: int              # surviving filters x k x classes? no: x1 (shared)
    table_bits: int           # surviving filters x entries (all classes)
    adds: int                 # popcount + ensemble + bias adds
    num_classes: int
    max_filters: int          # widest discriminator (adder tree depth)
    num_submodels: int
    # word-aligned uint32 storage (4-byte granularity) when derived from a
    # real artifact's packed planes; 0 for hand-built calibration counts
    packed_table_bytes: int = 0

    @property
    def table_bytes(self) -> int:
        """Packed table storage the memory system actually holds — the
        measured word planes when available, else table_bits rounded up
        to whole bytes (1 bit per entry either way)."""
        return self.packed_table_bytes or -(-self.table_bits // 8)

    @property
    def compressed_input_bits(self) -> int:
        # paper's bus compression: ceil(log2(T+1)) bits per input feature
        return self.input_features * max(1, math.ceil(
            math.log2(self.bits_per_input + 1)))

    @property
    def unary_input_bits(self) -> int:
        return self.input_features * self.bits_per_input


def counts_from_artifact(art) -> ModelCounts:
    """ModelCounts from a `repro_torch.core.export.InferenceArtifact`
    (numpy fields, the JAX package's artifact layout).

    Table storage is read off the artifact's packed uint32 word planes
    (`sm.packed.shape[-1]` words × 32 bits), so the hardware model
    accounts the word-aligned bytes the accelerator (and the packed serve
    path, DESIGN §2 "Packed layout") actually holds — identical to
    surviving × entries for E ≥ 32, rounded up to one word below that.
    """
    hash_ops = sum(sm.perm.shape[0] * sm.num_hashes for sm in art.submodels)
    lookups = sum(int(sm.mask.sum()) * sm.num_hashes for sm in art.submodels)
    table_bits = sum(int(sm.mask.sum()) * sm.packed.shape[-1] * 32
                     for sm in art.submodels)
    adds = sum(int(sm.mask.sum()) for sm in art.submodels) + \
        art.num_classes * (len(art.submodels) + 1)
    max_f = max(sm.perm.shape[0] for sm in art.submodels)
    f = art.total_bits // art.bits_per_input
    return ModelCounts(input_features=f, bits_per_input=art.bits_per_input,
                       hash_ops=hash_ops, lookups=lookups,
                       table_bits=table_bits, adds=adds,
                       num_classes=art.num_classes, max_filters=max_f,
                       num_submodels=len(art.submodels),
                       packed_table_bytes=table_bits // 8)


@dataclasses.dataclass(frozen=True)
class HwReport:
    platform: str
    ii_cycles: int
    latency_cycles: int
    latency_us: float
    throughput_kips: float
    power_w: float
    energy_uj_batch1: float
    energy_uj_steady: float
    area_mm2: Optional[float]


def evaluate_design(c: ModelCounts, plat: Platform,
                    compress_input: bool = True) -> HwReport:
    in_bits = c.compressed_input_bits if compress_input else c.unary_input_bits
    ii = math.ceil(in_bits / plat.bus_bits)
    # The hash block is sized to the bus (paper: "reduce the number of hash
    # units to the minimum sufficient for maximum throughput"), so hashing
    # streams behind deserialisation; depth = accumulate-partials + lookup +
    # adder tree + ensemble sum + argmax.
    hash_units = max(1, math.ceil(c.hash_ops / ii))
    depth = (ii                                   # deserialise
             + math.ceil(c.hash_ops / hash_units) # central hash block
             + 2                                  # lookup + valid
             + math.ceil(math.log2(max(2, c.max_filters)))  # popcount tree
             + c.num_submodels                    # ensemble accumulation
             + math.ceil(math.log2(max(2, c.num_classes))))  # argmax
    lat_s = depth / plat.freq_hz
    xput = plat.freq_hz / ii
    # dynamic energy per inference + area-proportional static power
    e_dyn = (plat.e_hash * c.hash_ops + plat.e_lookup * c.lookups
             + plat.e_add * c.adds + plat.e_io * in_bits)
    p_idle = plat.p_static + plat.e_leak * c.table_bits
    power = p_idle + e_dyn * xput
    e_steady = power / xput
    e_b1 = p_idle * lat_s + e_dyn
    area = None
    if plat.a_table or plat.a_logic:
        area = plat.a_table * c.table_bits + plat.a_logic * (
            hash_units * 32 + c.adds)
    return HwReport(platform=plat.name, ii_cycles=ii, latency_cycles=depth,
                    latency_us=lat_s * 1e6, throughput_kips=xput / 1e3,
                    power_w=power, energy_uj_batch1=e_b1 * 1e6,
                    energy_uj_steady=e_steady * 1e6, area_mm2=area)


# ---------------------------------------------------------------------------
# Calibration against the paper's published design points
# ---------------------------------------------------------------------------

# (counts, published power W) for ULN-S/M/L on each platform. Structural
# counts from Table I (filters = ceil(784*T/n) per submodel, x10 classes
# for lookups; 30% pruned).
def _uln_counts(bits_per_input, subs) -> ModelCounts:
    # subs: list of (inputs_per_filter, entries)
    f = 784
    n_fs = [math.ceil(f * bits_per_input / n) for n, _ in subs]
    surviving = [int(0.7 * n_f) * 10 for n_f in n_fs]   # 30% pruned, 10 cls
    hash_ops = sum(n_f * 2 for n_f in n_fs)
    lookups = sum(s * 2 for s in surviving)
    table_bits = sum(s * e for s, (_, e) in zip(surviving, subs))
    adds = sum(surviving) + 10 * (len(subs) + 1)
    return ModelCounts(f, bits_per_input, hash_ops, lookups, table_bits, adds,
                       10, max(n_fs), len(subs))


ULN_S = _uln_counts(2, [(12, 64), (16, 64), (20, 64)])
ULN_M = _uln_counts(3, [(12, 64), (16, 128), (20, 256), (28, 256), (36, 512)])
ULN_L = _uln_counts(7, [(12, 64), (16, 128), (20, 128), (24, 256), (28, 256),
                        (32, 512)])

_PAPER_FPGA = [(ULN_S, FPGA_Z7045, 1.1), (ULN_M, FPGA_Z7045, 3.1),
               (ULN_L, FPGA_Z7045_SLOW, 3.4)]
_PAPER_ASIC = [(ULN_S, ASIC_45NM, 0.84), (ULN_M, ASIC_45NM, 2.58),
               (ULN_L, ASIC_45NM, 6.23)]
_PAPER_AREA = [(ULN_S, 0.61), (ULN_M, 2.09), (ULN_L, 5.22)]


def _nnls3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact non-negative least squares for tiny systems by active-set
    enumeration: try every subset of variables clamped to zero, solve the
    unconstrained LS on the rest, keep the best feasible solution."""
    n = a.shape[1]
    best, best_r = np.zeros(n), float(np.linalg.norm(b))
    for mask in range(1, 1 << n):
        idx = [i for i in range(n) if mask & (1 << i)]
        sol, *_ = np.linalg.lstsq(a[:, idx], b, rcond=None)
        if (sol < 0).any():
            continue
        x = np.zeros(n)
        x[idx] = sol
        r = float(np.linalg.norm(a @ x - b))
        if r < best_r - 1e-12:
            best, best_r = x, r
    return best


def calibrate(points, base: Platform, p_static: float) -> Platform:
    """Non-negative least squares fit of per-op energies to published power.

    3 design points, 3 unknowns (e_add tied to e_lookup/4: an adder-tree
    add costs roughly a quarter of a table read in both substrates).
    Columns are normalised before the fit — the raw design matrix spans
    ~6 orders of magnitude and defeats gradient projection."""
    rows, rhs = [], []
    for c, plat, watts in points:
        in_bits = c.compressed_input_bits
        ii = math.ceil(in_bits / plat.bus_bits)
        xput = plat.freq_hz / ii
        rows.append([c.hash_ops * xput,
                     (c.lookups + 0.25 * c.adds) * xput,
                     in_bits * xput,
                     c.table_bits])              # leakage ~ area
        rhs.append(watts - p_static)
    a = np.array(rows)
    b = np.array(rhs)
    scale = np.linalg.norm(a, axis=0)
    x = _nnls3(a / scale[None], b) / scale
    return dataclasses.replace(base, e_hash=x[0], e_lookup=x[1],
                               e_add=0.25 * x[1], e_io=x[2], e_leak=x[3],
                               p_static=p_static)


def calibrate_area(base: Platform) -> Platform:
    """Fit area = a_table*table_bits + a_logic*logic_ops with the SAME
    logic-op count evaluate_design uses (hash_units*32 + adds)."""
    rows, rhs = [], []
    for c, area in _PAPER_AREA:
        ii = math.ceil(c.compressed_input_bits / base.bus_bits)
        hash_units = max(1, math.ceil(c.hash_ops / ii))
        rows.append([c.table_bits, hash_units * 32 + c.adds])
        rhs.append(area)
    a = np.array(rows)
    scale = np.linalg.norm(a, axis=0)
    x = _nnls3(a / scale[None], np.array(rhs)) / scale
    return dataclasses.replace(base, a_table=x[0], a_logic=x[1])


def _best_static(points, base) -> "Platform":
    """Grid-search the baseline static power (an assumed constant, not a
    published number) to minimise the worst relative power error."""
    best, best_err = None, float("inf")
    for p_static in np.linspace(0.0, 1.0, 21):
        plat = calibrate(points, base, p_static=float(p_static))
        err = max(abs(evaluate_design(c, dataclasses.replace(
            plat, freq_hz=pl.freq_hz, bus_bits=pl.bus_bits)).power_w - w) / w
            for c, pl, w in points)
        if err < best_err:
            best, best_err = plat, err
    return best


def calibrated_platforms() -> dict:
    fpga = _best_static(_PAPER_FPGA, FPGA_Z7045)
    asic = _best_static(_PAPER_ASIC, ASIC_45NM)
    asic = calibrate_area(asic)
    return {"fpga": fpga,
            "fpga@85": dataclasses.replace(fpga, freq_hz=85e6,
                                           name=FPGA_Z7045_SLOW.name),
            "asic": asic}
