"""Deployment operator: a level-triggered reconcile loop for graphs.

Counterpart of ``dynamo_exp_tpu/deploy/operator.py``:

- **Desired state** is the deployment records in an ApiStore directory
  (artifact, image, per-service ``services_spec`` overrides) and the K8s
  manifests rendered for them (``deploy/k8s.py``).
- **Actual state** lives behind a ``ClusterBackend``: ``KubectlBackend``
  drives a real cluster through ``kubectl``; ``MemoryBackend`` applies
  into process memory, with a readiness set a test controls.
- **Reconcile** is level-triggered and idempotent: each pass renders the
  desired documents, diffs them by content hash against what the
  backend holds, applies only the ones that drifted, deletes the ones no
  longer desired, garbage-collects every document of a deployment whose
  record is gone (the finalizer), and writes a status condition (phase
  and per-service readiness) back onto the record.

The port reads a record's ``manifests_yaml`` back with ``json``, one
document at a time (``k8s.from_yaml``), and writes JSON to ``kubectl``'s
stdin; the JAX operator uses PyYAML. Its owner label and hash annotation
name the port (``dynamo-exp-tpu-torch/content-hash``).

    python -m dynamo_exp_tpu_torch.deploy.operator \
        --store-dir /var/lib/dynamo/store --backend kubectl --interval 10
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import json
import logging
import os
import time
from dataclasses import dataclass, field

from .artifact import read_manifest
from .k8s import DEFAULT_IMAGE, from_yaml, render_graph_manifests

logger = logging.getLogger(__name__)


def _doc_key(doc: dict) -> tuple[str, str]:
    return (doc.get("kind", ""), doc.get("metadata", {}).get("name", ""))


def _doc_hash(doc: dict) -> str:
    return hashlib.sha256(json.dumps(doc, sort_keys=True).encode()).hexdigest()[:16]


class ClusterBackend:
    """What the reconciler drives. Implementations must be idempotent."""

    async def apply(self, deployment: str, doc: dict) -> None:
        raise NotImplementedError

    async def delete(self, deployment: str, key: tuple[str, str]) -> None:
        raise NotImplementedError

    async def list_applied(self, deployment: str) -> dict[tuple[str, str], str]:
        """{(kind, name): content_hash} of the resources this operator owns."""
        raise NotImplementedError

    async def ready(self, deployment: str, key: tuple[str, str]) -> bool:
        """Is the resource serving (a Deployment's availability)?"""
        raise NotImplementedError


class MemoryBackend(ClusterBackend):
    """An in-memory cluster: applied documents and a readiness set."""

    def __init__(self):
        self.applied: dict[str, dict[tuple[str, str], dict]] = {}
        self.ready_keys: set[tuple[str, tuple[str, str]]] = set()
        self.auto_ready = True  # newly applied resources report ready

    async def apply(self, deployment: str, doc: dict) -> None:
        self.applied.setdefault(deployment, {})[_doc_key(doc)] = doc
        if self.auto_ready:
            self.ready_keys.add((deployment, _doc_key(doc)))

    async def delete(self, deployment: str, key: tuple[str, str]) -> None:
        self.applied.get(deployment, {}).pop(key, None)
        self.ready_keys.discard((deployment, key))

    async def list_applied(self, deployment: str) -> dict[tuple[str, str], str]:
        return {k: _doc_hash(d) for k, d in self.applied.get(deployment, {}).items()}

    async def ready(self, deployment: str, key: tuple[str, str]) -> bool:
        return (deployment, key) in self.ready_keys


class KubectlBackend(ClusterBackend):
    """A real cluster through ``kubectl`` (apply from stdin). Owned
    resources carry a label selector and a content-hash annotation, so
    that diffing needs no local state."""

    OWNER = "dynamo-exp-tpu-torch-operator"
    OWNER_LABEL = f"app.kubernetes.io/managed-by={OWNER}"
    DEPLOYMENT_LABEL = "dynamo-exp-tpu-torch/deployment"
    HASH_ANNOTATION = "dynamo-exp-tpu-torch/content-hash"

    def __init__(self, namespace: str = "default", kubectl: str = "kubectl"):
        self.namespace = namespace
        self.kubectl = kubectl

    async def _run(self, *args: str, stdin: str | None = None) -> str:
        proc = await asyncio.create_subprocess_exec(
            self.kubectl, "-n", self.namespace, *args,
            stdin=asyncio.subprocess.PIPE if stdin is not None else None,
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE,
        )
        out, err = await proc.communicate(stdin.encode() if stdin is not None else None)
        if proc.returncode != 0:
            raise RuntimeError(f"kubectl {' '.join(args)}: {err.decode()}")
        return out.decode()

    def _decorate(self, deployment: str, doc: dict, content_hash: str) -> dict:
        meta = doc.setdefault("metadata", {})
        labels = meta.setdefault("labels", {})
        labels["app.kubernetes.io/managed-by"] = self.OWNER
        labels[self.DEPLOYMENT_LABEL] = deployment
        meta.setdefault("annotations", {})[self.HASH_ANNOTATION] = content_hash
        return doc

    async def apply(self, deployment: str, doc: dict) -> None:
        # The hash of the document as rendered, before the ownership
        # labels: the reconciler compares list_applied() with
        # _doc_hash(rendered), so hashing the decorated document would
        # re-apply the whole graph on every pass.
        content_hash = _doc_hash(doc)
        await self._run("apply", "-f", "-",
                        stdin=json.dumps(self._decorate(deployment, doc, content_hash)))

    async def delete(self, deployment: str, key: tuple[str, str]) -> None:
        kind, name = key
        with contextlib.suppress(RuntimeError):  # already gone = done
            await self._run("delete", kind.lower(), name, "--ignore-not-found")

    async def list_applied(self, deployment: str) -> dict[tuple[str, str], str]:
        out: dict[tuple[str, str], str] = {}
        for kind in ("deployment", "service", "configmap"):
            raw = await self._run("get", kind, "-l", f"{self.DEPLOYMENT_LABEL}={deployment}",
                                  "-o", "json")
            for item in json.loads(raw).get("items", []):
                meta = item.get("metadata", {})
                out[(item.get("kind", kind.capitalize()), meta.get("name", ""))] = (
                    meta.get("annotations", {}).get(self.HASH_ANNOTATION, ""))
        return out

    async def ready(self, deployment: str, key: tuple[str, str]) -> bool:
        kind, name = key
        if kind != "Deployment":
            return True  # Services and the rest are ready on creation
        obj = json.loads(await self._run("get", "deployment", name, "-o", "json"))
        want = obj.get("spec", {}).get("replicas", 1)
        return obj.get("status", {}).get("availableReplicas", 0) >= want


@dataclass
class ReconcileResult:
    phase: str  # "Ready" | "Deploying" | "Failed"
    applied: int = 0
    deleted: int = 0
    services_ready: dict[str, bool] = field(default_factory=dict)
    message: str = ""


class DeploymentOperator:
    """Reconciles every deployment record in an ApiStore directory."""

    def __init__(self, store_dir: str, backend: ClusterBackend, interval_s: float = 10.0,
                 error_backoff_s: float = 5.0):
        self.store_dir = store_dir
        self.backend = backend
        self.interval_s = interval_s
        self.error_backoff_s = error_backoff_s
        self._task: asyncio.Task | None = None
        # Deployments seen applied; one whose record is gone is finalized
        # (its resources collected) on the next pass.
        self._known: set[str] = set()

    # ----------------------------------------------------------- desired
    def _deployments_dir(self) -> str:
        return os.path.join(self.store_dir, "deployments")

    def _records(self) -> dict[str, dict]:
        ddir = self._deployments_dir()
        out = {}
        if not os.path.isdir(ddir):
            return out
        for fn in os.listdir(ddir):
            if not fn.endswith(".json"):
                continue
            try:
                with open(os.path.join(ddir, fn), encoding="utf-8") as f:
                    rec = json.load(f)
                out[rec["name"]] = rec
            except Exception:  # a torn write: skipped, read again next pass
                logger.exception("unreadable deployment record %s", fn)
        return out

    def _desired_docs(self, rec: dict) -> list[dict]:
        if "manifests_yaml" in rec:
            docs = from_yaml(rec["manifests_yaml"])
        else:
            safe = f"{rec['artifact']}--{rec['version']}".replace("/", "_")
            art = os.path.join(self.store_dir, "artifacts", safe + ".tar.gz")
            docs = render_graph_manifests(read_manifest(art),
                                          image=rec.get("image", DEFAULT_IMAGE),
                                          deployment=rec["name"])
        # Per-service replica overrides (services_spec.<name>.replicas).
        overrides = rec.get("services_spec", {})
        for doc in docs:
            if doc.get("kind") != "Deployment":
                continue
            sname = doc["metadata"]["labels"].get("app.kubernetes.io/name", "")
            for svc, spec in overrides.items():
                if sname.endswith(svc.lower()) and "replicas" in spec:
                    doc["spec"]["replicas"] = int(spec["replicas"])
        return docs

    # --------------------------------------------------------- reconcile
    async def reconcile_one(self, name: str, rec: dict) -> ReconcileResult:
        """One idempotent pass over one deployment record."""
        desired = {_doc_key(d): d for d in self._desired_docs(rec)}
        applied = await self.backend.list_applied(name)
        n_applied = n_deleted = 0
        for key, doc in desired.items():
            if applied.get(key) != _doc_hash(doc):
                await self.backend.apply(name, doc)
                n_applied += 1
        for key in applied:
            if key not in desired:
                await self.backend.delete(name, key)
                n_deleted += 1
        services_ready = {key[1]: await self.backend.ready(name, key)
                          for key in desired if key[0] == "Deployment"}
        return ReconcileResult(phase="Ready" if all(services_ready.values()) else "Deploying",
                               applied=n_applied, deleted=n_deleted,
                               services_ready=services_ready)

    async def finalize(self, name: str) -> int:
        """The record is gone: remove every owned resource."""
        applied = await self.backend.list_applied(name)
        for key in applied:
            await self.backend.delete(name, key)
        logger.info("finalized deployment %s (%d resources)", name, len(applied))
        return len(applied)

    def _write_status(self, rec: dict, result: ReconcileResult) -> None:
        rec["status"] = {"phase": result.phase, "services_ready": result.services_ready,
                         "observed_unix": time.time(), "message": result.message}
        path = os.path.join(self._deployments_dir(), f"{rec['name']}.json")
        with open(path + ".tmp", "w", encoding="utf-8") as f:
            json.dump(rec, f)
        os.replace(path + ".tmp", path)

    async def reconcile_all(self) -> dict[str, ReconcileResult]:
        """One full level-triggered pass over the desired state."""
        records = self._records()
        results: dict[str, ReconcileResult] = {}
        for name, rec in records.items():
            try:
                result = await self.reconcile_one(name, rec)
                self._write_status(rec, result)
                self._known.add(name)
            except Exception as e:  # the other deployments go on
                logger.exception("reconcile %s failed", name)
                result = ReconcileResult(phase="Failed", message=str(e))
                with contextlib.suppress(Exception):
                    self._write_status(rec, result)
            results[name] = result
        for name in list(self._known - set(records)):
            try:
                await self.finalize(name)
                self._known.discard(name)
            except Exception:  # tried again next pass
                logger.exception("finalize %s failed", name)
        return results

    # -------------------------------------------------------------- loop
    async def start(self) -> None:
        self._task = asyncio.ensure_future(self._loop())

    async def _loop(self) -> None:
        while True:
            try:
                results = await self.reconcile_all()
                failed = any(r.phase == "Failed" for r in results.values())
                delay = self.error_backoff_s if failed else self.interval_s
            except Exception:  # the loop survives a pass's fault
                logger.exception("reconcile pass failed")
                delay = self.error_backoff_s
            await asyncio.sleep(delay)

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._task
            self._task = None


def main(argv: list[str] | None = None) -> int:
    import argparse

    from ..runtime.logging import configure_logging
    from ..runtime.runtime import run_until_signalled

    p = argparse.ArgumentParser(prog="dynamo-operator", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--store-dir", required=True)
    p.add_argument("--backend", choices=["kubectl", "memory"], default="kubectl")
    p.add_argument("--namespace", default="default")
    p.add_argument("--interval", type=float, default=10.0)
    args = p.parse_args(argv)
    configure_logging()
    backend = KubectlBackend(args.namespace) if args.backend == "kubectl" else MemoryBackend()
    op = DeploymentOperator(args.store_dir, backend, interval_s=args.interval)

    async def run() -> None:
        await op.start()
        try:
            await asyncio.Event().wait()  # until signalled
        finally:
            await op.close()

    run_until_signalled(run())
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
