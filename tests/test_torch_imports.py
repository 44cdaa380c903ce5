"""Import hygiene of the port: it never imports JAX or the JAX package,
nor a package the card's machine lacks.

Every module of ``dynamo_exp_tpu_torch`` is imported in a fresh
interpreter, which must then hold neither ``jax`` nor any
``dynamo_exp_tpu`` module in ``sys.modules``, nor any of the packages
the JAX package's ingress rests on and the H100 machine does not have
(``aiohttp``, ``pydantic``, ``tokenizers``, ``transformers``,
``prometheus_client``, ``safetensors``, ``sentencepiece``, ``gguf``,
``huggingface_hub``, PyYAML's ``yaml``). The parity tests are the only
other place where the two packages meet.
"""

import json
import os
import pkgutil
import subprocess
import sys

import dynamo_exp_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FORBIDDEN = (
    "jax", "jaxlib", "dynamo_exp_tpu", "aiohttp", "pydantic", "pydantic_core",
    "tokenizers", "transformers", "prometheus_client", "safetensors",
    "sentencepiece", "gguf", "huggingface_hub", "yaml",
)

_PROBE = """
import importlib, json, pkgutil, sys
import dynamo_exp_tpu_torch as pkg
names = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."))
for name in names:
    importlib.import_module(name)
forbidden = %r
bad = sorted(m for m in sys.modules if m.split(".")[0] in forbidden)
print(json.dumps({"modules": names, "bad": bad}))
""" % (FORBIDDEN,)


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    expected = {
        m.name
        for m in pkgutil.walk_packages(
            dynamo_exp_tpu_torch.__path__, "dynamo_exp_tpu_torch."
        )
    }
    assert set(result["modules"]) == expected
    for name in (
        "ops.ragged_attention", "models.llama", "engine.engine", "engine.offload",
        "engine.tiering", "tokens",
        "protocols.openai", "protocols.delta", "protocols.aggregator",
        "protocols.sse", "runtime.annotated", "runtime.pipeline", "tokenizer",
        "model_card", "preprocessor.prompt", "preprocessor.preprocessor",
        "backend", "engines.echo", "http.service", "http.client", "run",
        "spec", "spec.drafter", "spec.controller", "models.loader", "engine.graphs",
        "aot", "aot.lattice", "aot.warmup", "aot.compile",
        "telemetry", "telemetry.context", "telemetry.prom", "telemetry.spans",
        "telemetry.slo", "telemetry.flight", "telemetry.dispatch", "http.metrics",
        "http.admission", "http.wire", "runtime.logging",
        "runtime.transports", "runtime.transports.base", "runtime.transports.codec",
        "runtime.transports.inproc", "runtime.transports.coordinator",
        "runtime.transports.tcp", "runtime.config", "runtime.runtime", "runtime.health",
        "runtime.journal", "runtime.client", "runtime.push_router", "runtime.component",
        "kv_router", "kv_router.protocols", "kv_router.indexer", "kv_router.scheduler",
        "kv_router.publisher", "kv_router.metrics_aggregator", "kv_router.router",
        "local_model", "http.discovery",
        "recorder", "telemetry.timeline", "telemetry.anatomy", "telemetry.fingerprint",
        "telemetry.bench_compare", "sim", "sim.workload", "runtime.profiler", "llmctl",
        "runtime.pool", "runtime.transports.chaos", "native", "kv", "kv.persistent",
        "engine.config", "engine.kv_manager", "ops.moe", "ops.launches",
        "sdk", "sdk.service", "sdk.config", "sdk.dependency", "sdk.allocator",
        "sdk.serve_service", "sdk.serve", "planner", "planner.policy", "planner.connector",
        "planner.planner", "examples.llm.components.worker",
        "examples.llm.components.processor", "examples.llm.components.frontend",
        "examples.llm.components.prefill_worker", "examples.llm.graphs.agg",
        "examples.llm.graphs.agg_router", "examples.llm.graphs.disagg",
        "examples.llm.graphs.disagg_router", "protocols.request_template",
        "components", "components.mock_worker", "components.router", "components.metrics",
        "deploy", "deploy.artifact", "deploy.k8s", "deploy.api_store", "deploy.operator",
        "deploy.cli",
        "sim.core", "sim.report", "sim.fit", "sim.cluster",
        "tune", "tune.space", "tune.search", "tune.validate", "tune.artifact",
        "analysis", "analysis.core", "analysis.host_sync", "analysis.determinism",
        "analysis.ownership", "analysis.recompile", "analysis.zones", "analysis.runner",
        "analysis.__main__", "models.vision", "ops.ring_attention", "examples.multimodal",
        "examples.multimodal.multimodal_demo", "examples.multimodal.components.encode_worker",
    ):
        assert f"dynamo_exp_tpu_torch.{name}" in expected


def test_every_jax_module_has_a_counterpart_at_the_mirrored_path():
    """No ``.py`` file of ``dynamo_exp_tpu/`` lacks its counterpart in
    ``dynamo_exp_tpu_torch/``, and the root multimodal graph has its own
    under the port's ``examples/``."""
    missing = []
    for base, sub in (("dynamo_exp_tpu", ""), ("examples/multimodal", "examples/multimodal")):
        top = os.path.join(ROOT, base)
        for dirpath, _, files in os.walk(top):
            for f in files:
                if f.endswith(".py"):
                    rel = os.path.relpath(os.path.join(dirpath, f), top)
                    if not os.path.exists(os.path.join(ROOT, "dynamo_exp_tpu_torch", sub, rel)):
                        missing.append(os.path.join(base, rel))
    assert missing == []


def test_port_sources_name_no_jax_module():
    """The same rule read from the sources: no ``import jax``, no import
    from the JAX package and none of ``FORBIDDEN`` anywhere in the port."""
    pkg_dir = os.path.dirname(dynamo_exp_tpu_torch.__file__)
    offenders = []
    for dirpath, _, files in os.walk(pkg_dir):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path, encoding="utf-8") as fh:
                for i, line in enumerate(fh, 1):
                    s = line.strip()
                    if not s.startswith(("import ", "from ")):
                        continue
                    top = s.split()[1].split(".")[0]
                    if top in FORBIDDEN:
                        offenders.append(f"{path}:{i}: {s}")
    assert offenders == []


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    """``chip_smoke.py`` (the proof on the card, run where JAX is not
    installed) holds to the same rule: no forbidden import in its source
    (its imports sit inside functions), and importing it leaves none in
    ``sys.modules``."""
    path = os.path.join(ROOT, "chip_smoke.py")
    with open(path, encoding="utf-8") as fh:
        offenders = [
            f"{path}:{i}: {line.strip()}" for i, line in enumerate(fh, 1)
            if line.strip().startswith(("import ", "from "))
            and line.strip().split()[1].split(".")[0] in FORBIDDEN
        ]
    assert offenders == []
    probe = ("import json, sys; import chip_smoke; print(json.dumps(sorted("
             "m for m in sys.modules if m.split('.')[0] in %r)))" % (FORBIDDEN,))
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
