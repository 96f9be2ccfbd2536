"""Analytic per-request energy/time model (hardware-adaptation layer).

The paper measures Llama2 on A100-40GB with nvidia-smi + CarbonTracker; this
container has no GPU, so request energy is derived from a calibrated
roofline model (documented in DESIGN.md §4):

  * decode is memory-bound:  t_token ≈ bytes(params + KV ctx) / HBM_bw
  * prefill is compute-bound: t ≈ 2 · N_active · S_prompt / (MFU · peak)
  * energy = t × (util · P_peak + (1-util) · P_idle) × PUE-at-accounting

The model reproduces the paper's two empirical anchors: (i) carbon/request
is linear in generated tokens (Fig. 2b); (ii) the 13B slope ≈ 1.85× the 7B
slope (Fig. 2a). A real deployment swaps this for telemetry via the same
``EnergyModel`` interface (``measure(request) -> (energy_kwh, seconds)``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float        # FLOP/s (bf16)
    hbm_bw: float            # bytes/s
    power_peak: float        # W at full utilization
    power_idle: float        # W idle
    embodied_gco2: float     # manufacturing carbon per device, gCO2
    lifetime_s: float = 5 * 365 * 24 * 3600.0  # paper: five-year lifespan
    ici_bw: float = 300e9    # bytes/s per chip over the interconnect


A100_40GB = HardwareSpec(
    name="a100-40gb", peak_flops=312e12, hbm_bw=1.555e12,
    power_peak=250.0, power_idle=50.0, embodied_gco2=150_000.0,
    ici_bw=600e9 / 2)  # NVLink3: 600 GB/s bidirectional, half per direction

# H100 SXM 80 GB — the port's deployment target (data sheet: bf16 dense,
# HBM3, board power). No public idle-power or embodied-carbon figure is
# on record here, so those two keep the A100 entry's values.
H100_SXM_80GB = HardwareSpec(
    name="h100-sxm-80gb", peak_flops=989e12, hbm_bw=3.35e12,
    power_peak=700.0, power_idle=50.0, embodied_gco2=150_000.0,
    ici_bw=900e9 / 2)  # NVLink4: 900 GB/s bidirectional, half per direction

# TPU v5e — deployment target (roofline constants from the assignment).
TPU_V5E = HardwareSpec(
    name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
    power_peak=220.0, power_idle=60.0, embodied_gco2=120_000.0,
    ici_bw=186e9)  # 4-link ICI, ~186 GB/s aggregate per chip


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    name: str
    n_params: float          # total parameters
    n_active: float = 0.0    # active params per token (MoE); 0 -> n_params
    kv_bytes_per_token: float = 0.0
    param_bytes: float = 0.0  # 0 -> 2 * n_params (bf16)
    kv_quant: str = ""       # "" (16-bit) | "int8" — bookkeeping tag only
    d_model: int = 0         # hidden width (0 -> collective bytes unknown)
    n_layers: int = 0        # transformer depth (0 -> collective unknown)

    @property
    def active(self) -> float:
        return self.n_active or self.n_params

    @property
    def pbytes(self) -> float:
        return self.param_bytes or 2.0 * self.n_params

    def with_int8_kv(self, head_dim: int = 128) -> "ModelProfile":
        """The same model serving an int8-quantized KV cache: each 16-bit
        K/V element becomes 1 byte plus a float32 per-token-per-head scale
        amortized over ``head_dim`` elements (~2x fewer decode KV bytes —
        the serving engine's ``kv_int8`` flag, models/attention.py). The
        resulting profile flows unchanged through ``measure`` into
        LevelProfiles and gateway carbon accounting."""
        elems = self.kv_bytes_per_token / 2.0        # 16-bit baseline
        int8_bytes = elems * 1.0 + (elems / head_dim) * 4.0
        return dataclasses.replace(
            self, name=f"{self.name}-kv8", kv_bytes_per_token=int8_bytes,
            kv_quant="int8")


LLAMA2_13B = ModelProfile("llama2-13b", 13.0e9,
                          kv_bytes_per_token=40 * 40 * 128 * 2 * 2.0,
                          d_model=5120, n_layers=40)
LLAMA2_7B = ModelProfile("llama2-7b", 7.0e9,
                         kv_bytes_per_token=32 * 32 * 128 * 2 * 2.0,
                         d_model=4096, n_layers=32)


class EnergyModel:
    """Per-request (energy, time) under batched continuous serving.

    ``batch`` is the average number of co-scheduled sequences: parameter
    reads amortize across the batch during decode (the dominant effect that
    makes batched serving energy-efficient); KV reads do not.

    ``n_chips`` prices a tensor-parallel fleet (DESIGN.md §14): weights and
    the KV store split evenly over the chips, so per-chip HBM traffic is
    total/n_chips, but every decoded token pays two all-reduces per layer
    over the interconnect; decode t_token is the roofline max of the two.
    ``n_chips=1`` is numerically identical to the single-chip model.
    """

    def __init__(self, hw: HardwareSpec = A100_40GB, *, mfu: float = 0.45,
                 batch: int = 8, decode_overhead: float = 1.25,
                 trust_wall_time: bool = False, n_chips: int = 1):
        assert n_chips >= 1
        self.hw = hw
        self.mfu = mfu
        self.batch = batch
        self.n_chips = n_chips
        self.decode_overhead = decode_overhead  # dequant, sampling, host
        # True when the serving hardware IS the accounting target, so
        # measured decode wall seconds replace the modeled decode duration
        # in measure(); False in this container, where a reduced CPU config
        # stands in for the target device and only token counts transfer
        self.trust_wall_time = trust_wall_time

    def with_chips(self, n_chips: int) -> "EnergyModel":
        """This model repriced for an ``n_chips`` tensor-parallel fleet.
        Returns ``self`` unchanged at the current chip count, so tp=1
        pools pay no object churn and keep bit-identical accounting."""
        if n_chips == self.n_chips:
            return self
        return EnergyModel(self.hw, mfu=self.mfu, batch=self.batch,
                           decode_overhead=self.decode_overhead,
                           trust_wall_time=self.trust_wall_time,
                           n_chips=n_chips)

    # ----- time ------------------------------------------------------
    def prefill_time(self, m: ModelProfile, prompt_tokens: int) -> float:
        flops = 2.0 * m.active * prompt_tokens
        return flops / (self.mfu * self.hw.peak_flops * self.n_chips)

    def collective_bytes_per_token(self, m: ModelProfile) -> float:
        """Interconnect bytes one chip moves per decoded token: two
        all-reduces per layer (post-attention, post-MLP) over a (1,
        d_model) bf16 activation; ring all-reduce moves 2(T-1)/T of the
        payload per chip. Zero when the profile carries no geometry or
        when there is nothing to reduce (one chip)."""
        if self.n_chips == 1 or not (m.d_model and m.n_layers):
            return 0.0
        ring = 2.0 * (self.n_chips - 1) / self.n_chips
        return 2.0 * m.n_layers * ring * m.d_model * 2.0

    def decode_bytes_per_token(self, m: ModelProfile,
                               context_tokens: int) -> float:
        """Modeled HBM bytes streamed per decoded token at a given live
        context — the §4 roofline numerator (param reads amortized over the
        batch; KV reads are per-request and dominate at depth, which is why
        int8 KV halves decode energy)."""
        return m.pbytes / self.batch + m.kv_bytes_per_token * context_tokens

    def decode_kv_bytes_per_token(self, m: ModelProfile,
                                  context_tokens: int) -> float:
        """KV-only share of ``decode_bytes_per_token`` (the term paging and
        int8 quantization act on)."""
        return m.kv_bytes_per_token * context_tokens

    def decode_time(self, m: ModelProfile, gen_tokens: int,
                    context_tokens: int) -> float:
        """Time attributable to ONE request generating ``gen_tokens``."""
        # average context over the generation: context + gen/2. Per chip:
        # HBM traffic splits n_chips ways; the collective term overlaps
        # with it only up to the roofline max (whichever pipe is slower
        # sets the token time).
        hbm_t = (self.decode_bytes_per_token(m, context_tokens + gen_tokens / 2.0)
                 / self.n_chips / self.hw.hbm_bw)
        ici_t = self.collective_bytes_per_token(m) / self.hw.ici_bw
        return gen_tokens * max(hbm_t, ici_t) * self.decode_overhead

    def request_time(self, m: ModelProfile, prompt_tokens: int,
                     gen_tokens: int) -> float:
        return (self.prefill_time(m, prompt_tokens)
                + self.decode_time(m, gen_tokens, prompt_tokens))

    # ----- energy ----------------------------------------------------
    def _power(self, util: float) -> float:
        # every chip in the fleet draws power for the request's duration
        per_chip = util * self.hw.power_peak + (1 - util) * self.hw.power_idle
        return per_chip * self.n_chips

    def request_energy_kwh(self, m: ModelProfile, prompt_tokens: int,
                           gen_tokens: int) -> float:
        tp = self.prefill_time(m, prompt_tokens)
        td = self.decode_time(m, gen_tokens, prompt_tokens)
        joules = tp * self._power(0.85) + td * self._power(0.55)
        return joules / 3.6e6

    def joules_per_token(self, m: ModelProfile, context: int = 512) -> float:
        return self.request_energy_kwh(m, 0, 1) * 3.6e6 + 0 * context

    # ----- telemetry -------------------------------------------------
    def measure(self, m: ModelProfile, prompt_tokens: int, gen_tokens: int,
                decode_s: float = 0.0) -> "tuple[float, float]":
        """Engine telemetry -> (energy_kwh, seconds).

        This is the interface a live deployment implements with power
        telemetry (nvidia-smi / TPU power rails). Here the measured token
        counts drive the calibrated roofline; when ``trust_wall_time`` the
        measured decode-only wall seconds replace the modeled decode
        duration in both the time and energy terms.
        """
        if self.trust_wall_time and decode_s > 0.0:
            tp = self.prefill_time(m, prompt_tokens)
            joules = tp * self._power(0.85) + decode_s * self._power(0.55)
            return joules / 3.6e6, tp + decode_s
        return (self.request_energy_kwh(m, prompt_tokens, gen_tokens),
                self.request_time(m, prompt_tokens, gen_tokens))
