"""Build deployable artifacts from SDK graphs.

Counterpart of ``dynamo_exp_tpu/deploy/artifact.py``: an artifact is a
content-addressed ``.tar.gz`` holding

- ``manifest.json``: the graph target, each service's spec (name,
  namespace, workers, resources, endpoints, dependencies), the service
  config's text and the digest. The field keeps the JAX name
  ``config_yaml``; the port's configs are JSON, which is YAML too.
- the source tree of the packages the graph imports from (relative to
  the build root), so that a runner can serve it with the unpacked tree
  alone on ``PYTHONPATH``.

The digest is a sha256 over the manifest body (version empty) and every
packed file, so two builds of the same source are the same version; the
api-store dedupes on it.

The port's graphs live inside its package
(``dynamo_exp_tpu_torch.examples.llm.graphs.*``), so the default package
packed is the whole port. Beside the ``.py``, ``.yaml`` and ``.json``
files the JAX tier packs, the port packs the kernels' sources (``.cu``,
``.cuh``, ``.cpp``, ``.h``): a worker of the unpacked tree builds its
kernels from them. Build outputs (``_build/``) are never packed.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import tarfile
import time
from dataclasses import asdict, dataclass, field

SOURCE_SUFFIXES = (".py", ".yaml", ".json", ".cu", ".cuh", ".cpp", ".h")
SKIPPED_DIRS = ("__pycache__", "_build")


@dataclass
class ServiceManifest:
    name: str
    namespace: str
    workers: int
    resources: dict
    endpoints: list[str]
    depends_on: list[str] = field(default_factory=list)


@dataclass
class ArtifactManifest:
    name: str
    graph_target: str  # "package.module:RootService"
    services: list[ServiceManifest]
    config_yaml: str = ""  # the service config's text (JSON in the port)
    version: str = ""  # content digest, filled by build
    created_unix: float = 0.0

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, raw: str) -> "ArtifactManifest":
        d = json.loads(raw)
        d["services"] = [ServiceManifest(**s) for s in d["services"]]
        return cls(**d)


def _load_graph(graph_target: str):
    from ..sdk.serve_service import load_target

    try:
        return load_target(graph_target)
    except SystemExit as e:  # the CLI helper's error, as a library error
        raise ValueError(f"graph target must be module:Class, got {graph_target!r}") from e


def _spec_dependencies(spec) -> list[str]:
    """Names of the services this one ``depends()`` on."""
    from ..sdk.dependency import depends
    from ..sdk.service import get_spec

    return [get_spec(val.target).name for val in vars(spec.cls).values()
            if isinstance(val, depends)]


def manifest_for_graph(graph_target: str, name: str | None = None,
                       config_path: str | None = None) -> ArtifactManifest:
    from ..sdk.service import discover_graph

    root = _load_graph(graph_target)
    services = [
        ServiceManifest(name=s.name, namespace=s.namespace, workers=s.workers,
                        resources=dict(s.resources), endpoints=sorted(s.endpoints),
                        depends_on=_spec_dependencies(s))
        for s in discover_graph(root)
    ]
    config_text = ""
    if config_path:
        with open(config_path, encoding="utf-8") as f:
            config_text = f.read()
    return ArtifactManifest(name=name or root.__name__.lower(), graph_target=graph_target,
                            services=services, config_yaml=config_text)


def _iter_source_files(src_root: str, packages: list[str]):
    for pkg in packages:
        base = os.path.join(src_root, pkg.replace(".", os.sep))
        if os.path.isfile(base + ".py"):
            yield base + ".py"
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames if d not in SKIPPED_DIRS]
            for fn in sorted(filenames):
                if fn.endswith(SOURCE_SUFFIXES):
                    yield os.path.join(dirpath, fn)


def build_artifact(graph_target: str, out_path: str, *, name: str | None = None,
                   config_path: str | None = None, src_root: str = ".",
                   packages: list[str] | None = None) -> ArtifactManifest:
    """Pack the graph into ``out_path`` (.tar.gz); returns the manifest,
    its ``version`` the content digest."""
    manifest = manifest_for_graph(graph_target, name, config_path)
    if packages is None:
        packages = [graph_target.partition(":")[0].split(".")[0]]
    files = sorted(_iter_source_files(src_root, packages))
    digest = hashlib.sha256()
    digest.update(manifest.to_json().encode())
    for path in files:
        digest.update(os.path.relpath(path, src_root).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    manifest.version = digest.hexdigest()[:16]
    manifest.created_unix = time.time()

    with tarfile.open(out_path, "w:gz") as tar:
        body = manifest.to_json().encode()
        info = tarfile.TarInfo("manifest.json")
        info.size = len(body)
        tar.addfile(info, io.BytesIO(body))
        for path in files:
            tar.add(path, arcname=os.path.relpath(path, src_root))
    return manifest


def read_manifest(artifact_path: str) -> ArtifactManifest:
    with tarfile.open(artifact_path, "r:gz") as tar:
        f = tar.extractfile("manifest.json")
        if f is None:
            raise ValueError(f"{artifact_path}: no manifest.json")
        return ArtifactManifest.from_json(f.read().decode())
