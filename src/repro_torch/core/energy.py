"""Energy/power model — the CPU-land stand-in for ElfCore's silicon numbers.

The container cannot measure µW; what it *can* do is count the exact
architectural events the chip's power decomposes into (synaptic ops, weight
updates, SRAM touches, leakage) and price them with the paper's measured
constants. All Fig. 7 / Table I reproductions report BOTH the counted events
(ours) and the modeled µW (ours × paper constants) next to the paper's
measured values — the *relative* claims (DSST −56 % learn power, gating −52 %
beyond zero-skipping, 16× vs [3]) are what we validate.

Constants and where they come from:
* 2.4 pJ/SOP @ 0.6 V / 20 MHz, 9.2 pJ/SOP @ 0.9 V (chip summary, Fig. 8).
* leakage 8 µW @ 0.6 V, 39 µW @ 0.9 V (chip summary).
* WU is priced as a SOP plus a weight-SRAM read-modify-write; SRAM energies
  use standard 28 nm figures (~5 fJ/bit read, ~8 fJ/bit write) — these only
  matter for the *split*, the totals are dominated by SOP counts.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    name: str
    vdd: float
    freq_hz: float
    e_sop_j: float        # energy per synaptic operation
    leakage_w: float

    @staticmethod
    def low_power() -> "OperatingPoint":
        return OperatingPoint("0.6V/20MHz", 0.6, 20e6, 2.4e-12, 8e-6)

    @staticmethod
    def high_perf() -> "OperatingPoint":
        return OperatingPoint("0.9V/155MHz", 0.9, 155e6, 9.2e-12, 39e-6)


E_SRAM_READ_PER_BIT = 5e-15   # 28nm-class
E_SRAM_WRITE_PER_BIT = 8e-15
WEIGHT_BITS = 8
INDEX_BITS = 9


@dataclasses.dataclass
class EnergyReport:
    sop_forward: float
    sop_wu: float
    sop_wu_offered: float
    duration_s: float
    op: OperatingPoint

    @property
    def e_forward_j(self) -> float:
        # forward SOP = MAC + weight read (+ index read when sparse)
        per = self.op.e_sop_j + (WEIGHT_BITS + INDEX_BITS) * E_SRAM_READ_PER_BIT
        return self.sop_forward * per

    @property
    def e_wu_j(self) -> float:
        # WU = MAC + weight read + weight write-back
        per = (self.op.e_sop_j
               + WEIGHT_BITS * (E_SRAM_READ_PER_BIT + E_SRAM_WRITE_PER_BIT))
        return self.sop_wu * per

    @property
    def e_leak_j(self) -> float:
        return self.op.leakage_w * self.duration_s

    @property
    def total_j(self) -> float:
        return self.e_forward_j + self.e_wu_j + self.e_leak_j

    @property
    def power_w(self) -> float:
        return self.total_j / max(self.duration_s, 1e-12)

    @property
    def wu_skip_rate(self) -> float:
        if self.sop_wu_offered <= 0:
            return 0.0
        return 1.0 - self.sop_wu / self.sop_wu_offered

    def as_dict(self) -> dict:
        return {
            "op_point": self.op.name,
            "sop_forward": self.sop_forward,
            "sop_wu": self.sop_wu,
            "wu_skip_rate": self.wu_skip_rate,
            "power_uW": self.power_w * 1e6,
            "e_per_sop_pJ": self.op.e_sop_j * 1e12,
        }


def report(sop_forward, sop_wu, sop_wu_offered, n_timesteps,
           op: OperatingPoint | None = None,
           cycles_per_ts: float = 512.0) -> EnergyReport:
    """Price counted events at an operating point.

    ``cycles_per_ts`` models the chip's event-driven duty cycle: one TS
    occupies roughly fan-in cycles on the serial input path; the AON SerDes
    clock-gates the core between TSs (we charge leakage for wall time).
    """
    op = op or OperatingPoint.low_power()
    duration = float(n_timesteps) * cycles_per_ts / op.freq_hz
    return EnergyReport(float(sop_forward), float(sop_wu), float(sop_wu_offered),
                        duration, op)


def network_capacity_efficiency(n_neurons: int, area_mm2: float, e_sop_pj: float) -> float:
    """NCE = max NN scale / (area × peak energy/SOP) — Table I footnote d."""
    return n_neurons / (area_mm2 * e_sop_pj)
