"""Import hygiene of the port: it never imports JAX or the JAX package,
nor a package the card's machine lacks.

Every module of ``dynamo_exp_tpu_torch`` is imported in a fresh
interpreter, which must then hold neither ``jax`` nor any
``dynamo_exp_tpu`` module in ``sys.modules``, nor any of the packages
the JAX package's ingress rests on and the H100 machine does not have
(``aiohttp``, ``pydantic``, ``tokenizers``, ``transformers``,
``prometheus_client``). The parity tests are the only other place where
the two packages meet.
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
    "tokenizers", "transformers", "prometheus_client",
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
        "spec", "spec.drafter", "spec.controller",
    ):
        assert f"dynamo_exp_tpu_torch.{name}" in expected


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
