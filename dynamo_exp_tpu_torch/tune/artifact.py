"""The tuned-config artifact ``llmctl tune`` emits.

Counterpart of ``dynamo_exp_tpu/tune/artifact.py``, the same JSON
layout. One file carries everything a deployment needs to *boot* the
recommendation, not just read it:

- the winning knob **overrides** plus the fully resolved live engine
  knob dict and its stable ``config_hash`` (the JAX package's hash of
  the same knobs);
- **provenance**: target fingerprint digest, search seed, objective
  scores, trial count, and the knob-space digest the search ran over
  (an artifact from a stale registry is detectable, not silently
  misapplied);
- the target **fingerprint** itself (when the target was one), which
  is what turns the artifact into a planner
  :class:`~dynamo_exp_tpu_torch.planner.policy.CatalogEntry`;
- the matching warm-boot **manifest**: the port's
  :class:`~dynamo_exp_tpu_torch.aot.lattice.GraphManifest` (where the
  JAX artifact carries its ``CompileManifest``), so booting from the
  artifact with ``prewarm_engine`` captures every graph before traffic
  and, against a kernel cache directory, builds nothing;
- the sim-vs-live **validation** verdict, when the validation stage
  ran.
"""

from __future__ import annotations

import json

from . import space

ARTIFACT_VERSION = 1


def resolved_live_knobs(overrides: dict) -> dict:
    """The full live engine knob dict the overrides resolve to:
    registry defaults overlaid with the engine-owner overrides. This,
    not the sparse overrides, is what ``config_hash`` covers, so two
    artifacts that resolve to the same engine agree on hash even if
    one spells a default explicitly."""
    out = {}
    for k in space.KNOBS:
        if k.owner == "engine" and k.live:
            out[k.name] = overrides.get(k.name, space.default_value(k))
    return out


def build_artifact(
    result,
    *,
    preset: str = "tiny",
    shape: dict | None = None,
    manifest=None,
    fingerprint=None,
    validation: dict | None = None,
) -> dict:
    """Assemble the artifact dict from a :class:`~.search.TuneResult`.
    ``shape`` is the non-tuned engine envelope (max_model_len,
    kv_dtype, tp) the deployment pins; ``manifest`` the matching
    :class:`~dynamo_exp_tpu_torch.aot.lattice.GraphManifest`."""
    knobs = resolved_live_knobs(result.best_overrides)
    art = {
        "version": ARTIFACT_VERSION,
        "overrides": {
            k: result.best_overrides[k] for k in sorted(result.best_overrides)
        },
        "config_hash": space.config_hash(knobs),
        "provenance": {
            "target": result.target_digest,
            "seed": result.seed,
            "objective": "goodput_per_chip_s * ttft_ok * itl_ok",
            "trials": result.trials,
            "space": space.space_digest(),
            "best_score": result.best_score,
            "default_score": result.default_score,
            "improvement": result.improvement,
        },
        "engine": {
            "preset": preset,
            "shape": dict(shape or {}),
            "knobs": knobs,
        },
        "fingerprint": (
            fingerprint.to_dict() if fingerprint is not None else None
        ),
        "validation": validation,
        "manifest": manifest.to_dict() if manifest is not None else None,
    }
    return art


def write_artifact(art: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(art, f, indent=2, sort_keys=True)
        f.write("\n")


def load_artifact(path: str) -> dict:
    with open(path) as f:
        art = json.load(f)
    if art.get("version") != ARTIFACT_VERSION:
        raise ValueError(
            f"unsupported tune artifact version {art.get('version')!r} "
            f"in {path} (expected {ARTIFACT_VERSION})"
        )
    return art


def engine_config_from_artifact(art: dict, model=None):
    """Boot config: preset model + pinned shape + the artifact's fully
    resolved engine knobs. ``model`` overrides the preset lookup (tests
    pass TINY directly; the smoke a preset cut in depth)."""
    from ..engine import EngineConfig

    if model is None:
        from ..models import PRESETS

        model = PRESETS[art["engine"]["preset"]]
    kwargs = dict(art["engine"]["shape"])
    kwargs.update(art["engine"]["knobs"])
    kwargs.setdefault("eos_token_ids", [])
    return EngineConfig(model=model, **kwargs)


def manifest_from_artifact(art: dict):
    """The artifact's :class:`~dynamo_exp_tpu_torch.aot.lattice.GraphManifest`
    (None when it was built without one)."""
    if art.get("manifest") is None:
        return None
    from ..aot import GraphManifest

    return GraphManifest.from_dict(art["manifest"])


def catalog_entry_from_artifact(art: dict, name: str = ""):
    """Turn the artifact into a planner catalog entry. Requires the
    artifact to carry its target fingerprint: a synthetic-target
    artifact has nothing for the drift comparison to key on."""
    from ..planner.policy import CatalogEntry
    from ..telemetry.fingerprint import WorkloadFingerprint

    if art.get("fingerprint") is None:
        raise ValueError(
            "tune artifact has no target fingerprint; only "
            "fingerprint-targeted artifacts can join a config catalog"
        )
    return CatalogEntry(
        name=name or art["provenance"]["target"],
        fingerprint=WorkloadFingerprint.from_dict(art["fingerprint"]),
        overrides=tuple(sorted(art["overrides"].items())),
        config_hash=art["config_hash"],
    )
