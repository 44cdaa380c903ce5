"""Sim-vs-live validation of tuned candidates.

Counterpart of ``dynamo_exp_tpu/tune/validate.py`` on the port's
:class:`~dynamo_exp_tpu_torch.engine.TorchEngine`. Before a
recommendation ships, the top-K candidates re-run against a live engine
whose shape mirrors the SimConfig under test, fronted by the real
AdmissionController (the simulator's calibration bridge), and the live
ranking must agree with the sim ranking (Kendall tau + top-1). A
candidate that only wins in the model is a modeling artifact, not a
tuning.

Where the JAX version boots a ``TINY`` engine with float32 KV, the
port's takes the engine's ``device`` (CUDA unless the caller asks for
the CPU; no card raises), its ``model`` (default ``TINY``) and
``kv_dtype`` (default float32), and an optional prebuilt ``Llama`` of
that model, so one set of weights serves every candidate. Each
candidate's warm pass runs before its measured pass: on a card it is
where the candidate's CUDA graphs are captured, so no candidate pays
for another's first-use captures; a second warm pass runs the measured
pass's own admitted set, and a measured pass that still captured is run
again.

This module reads wall clocks: it measures a real engine.
"""

from __future__ import annotations

from . import space
from .search import SearchSettings, TuneTarget, evaluate


def kendall_tau(a: list[float], b: list[float]) -> float:
    """Rank agreement between two score lists over the same candidates
    (b[i] scores the same candidate as a[i]); 1.0 = identical order,
    -1.0 = reversed. Ties count as discordant half-weight-free (they
    simply don't contribute)."""
    n = len(a)
    if n < 2:
        return 1.0
    conc = disc = 0
    for i in range(n):
        for j in range(i + 1, n):
            prod = (a[i] - a[j]) * (b[i] - b[j])
            if prod > 0:
                conc += 1
            elif prod < 0:
                disc += 1
    total = n * (n - 1) / 2
    return round((conc - disc) / total, 4)


def harness_workload(
    target: TuneTarget,
    seed: int,
    n: int = 10,
    rate_rps: float = 8.0,
    max_prompt: int = 96,
    max_new: int = 24,
):
    """The shared validation workload: the target replayed at harness
    scale (prompt/output lengths clamped to the harness model length).
    BOTH sides consume exactly this list, so ranking differences come
    from the configs, never the workload."""
    from dataclasses import replace

    reqs = TuneTarget(
        kind=target.kind,
        fingerprint=target.fingerprint,
        name=target.name or "burst",
        requests=n,
        rate_rps=rate_rps,
        duration_s=max(n / rate_rps, 1.0),
    ).workload(seed)
    return [
        replace(
            r,
            prompt_len=min(r.prompt_len, max_prompt),
            max_tokens=min(max(r.max_tokens, 2), max_new),
            prefix_group=-1,
            prefix_len=0,
        )
        for r in reqs
    ]


async def measure_live(
    overrides: dict,
    workload,
    harness: dict,
    slo_ttft_s: float = 30.0,
    slo_itl_s: float = 2.0,
    *,
    device="cuda",
    model=None,
    kv_dtype: str = "float32",
    llama=None,
    passes: int = 1,
) -> dict:
    """Run one candidate's live-applicable engine knobs on a real engine
    against the shared workload; score with the same composite shape the
    sim objective uses (1-instance chip-seconds = duration).

    The ``max_inflight`` knob (the edge admission bound) applies here
    too: it sizes the AdmissionController fronting the engine, so a
    candidate that sheds in the sim sheds on the harness for the same
    reason. The SLO gates default to harness scale: the ranking, not the
    absolute score, is the validated signal. The result also says what
    ran: the engine's device and layers, the ragged kernels' launches by
    design (warm and measured passes; none on the CPU), each measured
    pass's goodput, the first-use captures inside the scored passes (0
    unless three attempts at one all captured) and the attempts taken.
    ``passes`` measured passes (default one, the JAX harness's) are
    scored together: tokens over their summed duration."""
    import asyncio
    import time

    from ..engine import EngineConfig, TorchEngine
    from ..http.admission import AdmissionController, RequestShedError
    from ..models import TINY
    from ..ops import ragged_attention as tra
    from ..protocols.common import BackendInput, SamplingOptions

    kwargs = dict(harness)
    kwargs.update(space.engine_kwargs_from_overrides(overrides))
    cfg = EngineConfig(
        model=model or TINY, eos_token_ids=[], kv_dtype=kv_dtype, **kwargs
    )
    adm = AdmissionController(
        max_inflight=int(
            overrides.get("max_inflight") or max(len(workload), 4)
        )
    )
    launches_before = dict(tra.KERNEL_LAUNCHES)
    engine = TorchEngine(cfg, model=llama, device=device, seed=0)
    engine.start()
    try:
        results: list[dict] = []

        async def one(req, admit: bool = True, record: bool = True) -> None:
            if admit:
                await asyncio.sleep(req.arrival_s)
                try:
                    adm.acquire(req.priority)
                except RequestShedError:
                    if record:
                        results.append({"shed": True})
                    return
            try:
                bi = BackendInput(
                    token_ids=[
                        (17 * req.index + k) % 211 + 3
                        for k in range(req.prompt_len)
                    ],
                    priority=req.priority,
                )
                bi.stop_conditions.max_tokens = req.max_tokens
                bi.stop_conditions.ignore_eos = True
                bi.sampling_options = SamplingOptions(
                    temperature=0.9, seed=1000 + req.index
                )
                start = time.monotonic()  # dynlint: determinism(live validation wall-clock measurement)
                first = last = None
                tokens = 0
                stream = await engine.generate(bi.to_dict())
                async for item in stream:
                    now = time.monotonic()  # dynlint: determinism(live validation wall-clock measurement)
                    if item.get("token_ids"):
                        tokens += len(item["token_ids"])
                        if first is None:
                            first = now
                        last = now
                itl = (
                    (last - first) / (tokens - 1)
                    if first is not None and last is not None and tokens > 1
                    else 0.0
                )
                if record:
                    results.append({
                        "shed": False,
                        "tokens": tokens,
                        "ttft_s": (first - start) if first is not None else 0.0,
                        "itl_s": itl,
                    })
            finally:
                if admit:
                    adm.release()

        # Warm passes, nothing recorded: the whole workload
        # shape-for-shape with no admission and no arrival spread (the
        # JAX package's), then the measured pass's own shape (through
        # admission, so the requests a candidate sheds are shed here
        # too). On a card every decode window and mixed key's CUDA graph
        # is captured HERE, for each candidate alike; a key depends on
        # the rows a dispatch holds, so the admitted set's keys need the
        # second pass. Otherwise whichever candidate still owes a capture
        # donates that stall to its measured duration and the ranking
        # encodes cache state, not config quality.
        await asyncio.gather(
            *[one(r, admit=False, record=False) for r in workload]
        )
        await asyncio.gather(*[one(r, record=False) for r in workload])

        def misses() -> int:
            d = engine.metrics()["dispatch"]
            return sum(d[k]["compile_misses"] for k in ("window", "mixed"))

        # The measured passes (``passes``; the JAX harness runs one).
        # A pass that captured is run again (at most twice): a key also
        # depends on when rows join and leave a dispatch, so a pass can
        # still meet one the warm passes did not.
        kept: list[list[dict]] = []
        rates: list[float] = []
        duration = 0.0
        attempts = captures = 0
        while len(kept) < passes:
            for attempt in range(3):
                results.clear()
                before = misses()
                t0 = time.monotonic()  # dynlint: determinism(live validation wall-clock measurement)
                await asyncio.gather(*[one(r) for r in workload])
                dt = max(time.monotonic() - t0, 1e-6)  # dynlint: determinism(live validation wall-clock measurement)
                attempts += 1
                new = misses() - before
                if not new or attempt == 2:
                    captures += new
                    break
            kept.append(list(results))
            duration += dt
            rates.append(
                round(sum(r["tokens"] for r in results if not r["shed"]) / dt, 4)
            )
    finally:
        engine.stop()
    launches = {
        k: tra.KERNEL_LAUNCHES[k] - launches_before.get(k, 0)
        for k in tra.KERNEL_LAUNCHES
    }

    every = [r for res in kept for r in res]
    done = [r for r in every if not r["shed"]]
    completed = max(len(done), 1)
    ttft_ok = sum(1 for r in done if r["ttft_s"] <= slo_ttft_s) / completed
    itl_ok = sum(1 for r in done if r["itl_s"] <= slo_itl_s) / completed
    tokens = sum(r["tokens"] for r in done)
    goodput_per_chip_s = tokens / duration
    return {
        "score": round(goodput_per_chip_s * ttft_ok * itl_ok, 6),
        "goodput_per_chip_s": round(goodput_per_chip_s, 4),
        "ttft_compliance": round(ttft_ok, 4),
        "itl_compliance": round(itl_ok, 4),
        # Per pass (the admitted set is the same in every pass).
        "completed": len(done) // passes,
        "shed": sum(1 for r in every if r["shed"]) // passes,
        "chip_seconds": round(duration / passes, 3),
        "device": engine.device.type,
        "layers": cfg.model.num_layers,
        "kernel_launches": launches,
        "pass_goodput": rates,
        "captures_measured": captures,
        "measured_attempts": attempts,
    }


async def validate_candidates(
    candidates: list[dict],
    target: TuneTarget,
    seed: int,
    harness: dict | None = None,
    n: int = 10,
    slo_ttft_s: float = 30.0,
    slo_itl_s: float = 2.0,
    *,
    device="cuda",
    model=None,
    kv_dtype: str = "float32",
    llama=None,
    passes: int = 1,
) -> dict:
    """Rank the candidates in the sim AND on a live engine over one
    shared clamped workload; report both rankings plus Kendall tau and
    top-1 agreement. ``harness`` is the engine-shape envelope (defaults
    mirror the pressure harness, roomier pool).
    ``slo_ttft_s``/``slo_itl_s`` gate the live composite (harness-scale
    defaults; pass large values to rank on goodput alone). ``device``,
    ``model``, ``kv_dtype``, ``llama`` and ``passes`` go to
    :func:`measure_live`."""
    harness = harness or {
        "max_decode_slots": 4,
        "page_size": 8,
        "num_pages": 64,
        "max_model_len": 128,
        "preempt_stall_grace_s": 0.2,
    }
    workload = harness_workload(target, seed, n=n)
    sim_base = {
        "slots_per_instance": harness["max_decode_slots"],
        "pages_per_instance": harness["num_pages"],
        "page_size": harness["page_size"],
        "preempt_stall_grace_s": harness["preempt_stall_grace_s"],
        "max_inflight": max(len(workload), 4),
        "initial_instances": 1,
    }

    sim_settings = SearchSettings(
        seed=seed, base_sim=sim_base, eval_seeds=1
    )
    fixed = TuneTarget(
        kind="synthetic", name="burst", requests=len(workload)
    )

    sim_scores: list[float] = []
    live_scores: list[float] = []
    rows: list[dict] = []
    for i, overrides in enumerate(candidates):
        sim_comp = evaluate(
            overrides, fixed, sim_settings, seed, workload=list(workload)
        )
        live_comp = await measure_live(
            overrides,
            workload,
            harness,
            slo_ttft_s=slo_ttft_s,
            slo_itl_s=slo_itl_s,
            device=device,
            model=model,
            kv_dtype=kv_dtype,
            llama=llama,
            passes=passes,
        )
        sim_scores.append(sim_comp["score"])
        live_scores.append(live_comp["score"])
        rows.append({
            "candidate": i,
            "overrides": {k: overrides[k] for k in sorted(overrides)},
            "sim": sim_comp,
            "live": live_comp,
        })

    tau = kendall_tau(sim_scores, live_scores)
    top1 = (
        sim_scores.index(max(sim_scores))
        == live_scores.index(max(live_scores))
        if sim_scores
        else True
    )
    return {
        "candidates": rows,
        "sim_scores": sim_scores,
        "live_scores": live_scores,
        "kendall_tau": tau,
        "top1_agreement": top1,
        "agreed": top1 and tau >= 0.0,
    }
