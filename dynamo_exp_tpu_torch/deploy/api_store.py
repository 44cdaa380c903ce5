"""Artifact and deployment registry service (api-store).

Counterpart of ``dynamo_exp_tpu/deploy/api_store.py``, the same routes
and JSON bodies: content-addressed tarballs on local disk, deployments
as JSON records holding their rendered K8s manifests
(``manifests_yaml``, ``deploy/k8s.py``'s ``to_yaml``). The JAX store
serves through aiohttp; the port's through ``http/service.py``'s
``PlainServer`` (asyncio streams).

Routes:
  POST   /api/v1/artifacts                (body = .tar.gz)  -> {name, version}
  GET    /api/v1/artifacts                -> [manifest, ...]
  GET    /api/v1/artifacts/{name}/{ver}   -> tarball
  DELETE /api/v1/artifacts/{name}/{ver}
  POST   /api/v1/deployments              {artifact, version, image, name?}
  GET    /api/v1/deployments              -> [record, ...]
  GET    /api/v1/deployments/{name}       -> record (incl. manifests YAML)
  DELETE /api/v1/deployments/{name}

    python -m dynamo_exp_tpu_torch.deploy.api_store --store-dir DIR \
        [--host 0.0.0.0 --port 7070]

It prints ``api-store on http://host:port``; SIGTERM stops it (exit 0).
"""

from __future__ import annotations

import json
import os
import tempfile
import time

from ..http.wire import PlainResponse, PlainServer, plain_json
from .artifact import ArtifactManifest, read_manifest
from .k8s import DEFAULT_IMAGE, render_graph_manifests, to_yaml

MAX_ARTIFACT_BYTES = 1 << 30
_PREFIX = "/api/v1/"


class ApiStore:
    def __init__(self, store_dir: str):
        self.store_dir = store_dir
        os.makedirs(os.path.join(store_dir, "artifacts"), exist_ok=True)
        os.makedirs(os.path.join(store_dir, "deployments"), exist_ok=True)
        self._server: PlainServer | None = None
        self.address: str | None = None

    # ------------------------------------------------------------ storage
    def _artifact_path(self, name: str, version: str) -> str:
        safe = f"{name}--{version}".replace("/", "_")
        return os.path.join(self.store_dir, "artifacts", safe + ".tar.gz")

    def _deployment_path(self, name: str) -> str:
        return os.path.join(self.store_dir, "deployments", name.replace("/", "_") + ".json")

    def list_artifacts(self) -> list[ArtifactManifest]:
        adir = os.path.join(self.store_dir, "artifacts")
        return [read_manifest(os.path.join(adir, fn)) for fn in sorted(os.listdir(adir))
                if fn.endswith(".tar.gz")]

    # ------------------------------------------------------------- routes
    async def _handle(self, req) -> PlainResponse:
        parts = req.path[len(_PREFIX):].split("/") if req.path.startswith(_PREFIX) else []
        kind, args = (parts[0], parts[1:]) if parts else ("", [])
        route = {
            ("POST", "artifacts", 0): self._put_artifact,
            ("GET", "artifacts", 0): self._list_artifacts,
            ("GET", "artifacts", 2): self._get_artifact,
            ("DELETE", "artifacts", 2): self._delete_artifact,
            ("POST", "deployments", 0): self._create_deployment,
            ("GET", "deployments", 0): self._list_deployments,
            ("GET", "deployments", 1): self._get_deployment,
            ("DELETE", "deployments", 1): self._delete_deployment,
        }.get((req.method, kind, len(args)))
        if route is None:
            return plain_json({"error": "not found"}, 404)
        return await route(req, *args)

    async def _put_artifact(self, req) -> PlainResponse:
        with tempfile.NamedTemporaryFile(dir=self.store_dir, suffix=".tar.gz",
                                         delete=False) as tmp:
            tmp.write(req.body)
        try:
            manifest = read_manifest(tmp.name)
        except Exception as e:
            os.unlink(tmp.name)
            return plain_json({"error": f"not a valid artifact: {e}"}, 400)
        os.replace(tmp.name, self._artifact_path(manifest.name, manifest.version))
        return plain_json({"name": manifest.name, "version": manifest.version})

    async def _list_artifacts(self, req) -> PlainResponse:
        return plain_json([json.loads(m.to_json()) for m in self.list_artifacts()])

    async def _get_artifact(self, req, name: str, version: str) -> PlainResponse:
        path = self._artifact_path(name, version)
        if not os.path.exists(path):
            return plain_json({"error": "not found"}, 404)
        with open(path, "rb") as f:
            return PlainResponse(200, f.read(), "application/gzip")

    async def _delete_artifact(self, req, name: str, version: str) -> PlainResponse:
        return self._delete(self._artifact_path(name, version))

    async def _create_deployment(self, req) -> PlainResponse:
        try:
            spec = json.loads(req.body)
        except ValueError as e:
            return plain_json({"error": f"invalid JSON: {e}"}, 400)
        name = spec.get("name") or spec.get("artifact")
        art_path = self._artifact_path(spec.get("artifact", ""), spec.get("version", ""))
        if not os.path.exists(art_path):
            return plain_json({"error": "artifact not in store"}, 404)
        manifest = read_manifest(art_path)
        image = spec.get("image", DEFAULT_IMAGE)
        docs = render_graph_manifests(manifest, image=image, deployment=name)
        record = {
            "name": name,
            "artifact": manifest.name,
            "version": manifest.version,
            "image": image,
            "created_unix": time.time(),
            "manifests_yaml": to_yaml(docs),
            "services": [s.name for s in manifest.services],
        }
        with open(self._deployment_path(name), "w", encoding="utf-8") as f:
            json.dump(record, f)
        return plain_json({"name": name, "services": record["services"]})

    async def _list_deployments(self, req) -> PlainResponse:
        ddir = os.path.join(self.store_dir, "deployments")
        out = []
        for fn in sorted(os.listdir(ddir)):
            with open(os.path.join(ddir, fn), encoding="utf-8") as f:
                rec = json.load(f)
            out.append({k: rec[k] for k in ("name", "artifact", "version")})
        return plain_json(out)

    async def _get_deployment(self, req, name: str) -> PlainResponse:
        path = self._deployment_path(name)
        if not os.path.exists(path):
            return plain_json({"error": "not found"}, 404)
        with open(path, encoding="utf-8") as f:
            return plain_json(json.load(f))

    async def _delete_deployment(self, req, name: str) -> PlainResponse:
        return self._delete(self._deployment_path(name))

    @staticmethod
    def _delete(path: str) -> PlainResponse:
        if not os.path.exists(path):
            return plain_json({"error": "not found"}, 404)
        os.unlink(path)
        return plain_json({"deleted": True})

    # ---------------------------------------------------------- lifecycle
    async def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        self._server = PlainServer(self._handle, host, port, max_body=MAX_ARTIFACT_BYTES)
        self.address = f"http://{host}:{await self._server.start()}"
        return self.address

    async def close(self) -> None:
        if self._server is not None:
            await self._server.stop()
            self._server = None


def main(argv: list[str] | None = None) -> None:
    import argparse
    import asyncio

    from ..runtime.runtime import run_until_signalled

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--store-dir", default="./dynamo-store")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7070)
    args = p.parse_args(argv)

    async def run():
        store = ApiStore(args.store_dir)
        try:
            print(f"api-store on {await store.start(args.host, args.port)}", flush=True)
            await asyncio.Event().wait()
        finally:
            await store.close()

    run_until_signalled(run())


if __name__ == "__main__":
    main()
