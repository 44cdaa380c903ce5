"""Render K8s manifests for a graph artifact onto GPU node pools.

Counterpart of ``dynamo_exp_tpu/deploy/k8s.py``, the same documents:

- one coordinator Deployment and Service, the whole control plane
  (``runtime/transports/coordinator.py``); every component gets
  ``DYN_COORDINATOR`` pointing at it;
- the service config as a ConfigMap, mounted at ``/etc/dynamo``;
- one Deployment per service, its container running ``python -m
  dynamo_exp_tpu_torch.sdk.serve <target> --service-name <S> [-f
  /etc/dynamo/config.json]``, ``replicas`` the service's workers;
- a service with ``resources["gpu_hosts"] > 1`` (a multi-node group)
  renders one Deployment per host rank carrying ``--num-nodes
  --node-rank --deployment``; rank 0 publishes its address through the
  coordinator and the others find it there
  (``parallel/multihost.py``), so no headless Service is needed;
- an HTTP Service in front of the graph's root service (the Frontend).

Card-side differences from the JAX tier: ``resources={"gpu": n}``
renders ``limits: {"nvidia.com/gpu": "n"}`` and the node selector
``cloud.google.com/gke-accelerator`` (``nvidia-h100-80gb`` unless
``resources["gpu_accelerator"]`` names another; the JAX tier renders
``google.com/tpu`` and the TPU accelerator and topology selectors),
multi-node ranks come from ``gpu_hosts`` (JAX: ``tpu_hosts``), the
config file is ``config.json`` (the port reads no YAML), and
:func:`to_yaml` writes each document as JSON between ``---`` lines
(JSON is YAML 1.2, and ``kubectl apply`` takes it), since the port does
not import PyYAML; :func:`from_yaml` reads that text back.
"""

from __future__ import annotations

import json

from .artifact import ArtifactManifest, ServiceManifest

COORDINATOR_PORT = 6650
DEFAULT_IMAGE = "dynamo-exp-tpu-torch:latest"
DEFAULT_GPU_ACCEL = "nvidia-h100-80gb"
MANAGED_BY = "dynamo-exp-tpu-torch"
CONFIG_DIR = "/etc/dynamo"
CONFIG_FILE = "config.json"


def _meta(name: str, deployment: str) -> dict:
    return {"name": name, "labels": {
        "app.kubernetes.io/name": name,
        "app.kubernetes.io/part-of": deployment,
        "app.kubernetes.io/managed-by": MANAGED_BY,
    }}


def render_coordinator(deployment: str, image: str) -> list[dict]:
    name = f"{deployment}-coordinator"
    labels = {"app.kubernetes.io/name": name}
    container = {
        "name": "coordinator",
        "image": image,
        "command": ["python", "-m", "dynamo_exp_tpu_torch.runtime.transports.coordinator",
                    "--host", "0.0.0.0", "--port", str(COORDINATOR_PORT)],
        "ports": [{"containerPort": COORDINATOR_PORT}],
    }
    return [
        {"apiVersion": "apps/v1", "kind": "Deployment", "metadata": _meta(name, deployment),
         "spec": {"replicas": 1, "selector": {"matchLabels": dict(labels)},
                  "template": {"metadata": {"labels": dict(labels)},
                               "spec": {"containers": [container]}}}},
        {"apiVersion": "v1", "kind": "Service", "metadata": _meta(name, deployment),
         "spec": {"selector": labels, "ports": [{"port": COORDINATOR_PORT}]}},
    ]


def _gpu_pod_bits(resources: dict) -> tuple[dict, dict]:
    """(nodeSelector, container resources) for a service's request."""
    gpu = int(resources.get("gpu", 0))
    if gpu <= 0:
        limits = {k: str(v) for k, v in resources.items() if k in ("cpu", "memory")}
        return {}, ({"limits": limits} if limits else {})
    selector = {"cloud.google.com/gke-accelerator":
                resources.get("gpu_accelerator", DEFAULT_GPU_ACCEL)}
    return selector, {"limits": {"nvidia.com/gpu": str(gpu)}}


def render_component(svc: ServiceManifest, deployment: str, image: str, graph_target: str,
                     config_map: str | None) -> list[dict]:
    """The Deployment of one service of the graph (one a host rank for a
    multi-node group)."""
    coord = f"{deployment}-coordinator:{COORDINATOR_PORT}"
    hosts = int(svc.resources.get("gpu_hosts", 1))
    selector, container_res = _gpu_pod_bits(svc.resources)

    def one(rank: int | None) -> dict:
        name = f"{deployment}-{svc.name.lower()}"
        if rank is not None:
            name = f"{name}-{rank}"
        labels = {"app.kubernetes.io/name": name}
        cmd = ["python", "-m", "dynamo_exp_tpu_torch.sdk.serve", graph_target,
               "--service-name", svc.name]
        if config_map:
            cmd += ["-f", f"{CONFIG_DIR}/{CONFIG_FILE}"]
        if hosts > 1:
            cmd += ["--num-nodes", str(hosts), "--node-rank", str(rank),
                    "--deployment", deployment]
        container = {"name": svc.name.lower(), "image": image, "command": cmd,
                     "env": [{"name": "DYN_COORDINATOR", "value": coord}]}
        if container_res:
            container["resources"] = container_res
        if config_map:
            container["volumeMounts"] = [{"name": "config", "mountPath": CONFIG_DIR}]
        pod: dict = {"containers": [container]}
        if selector:
            pod["nodeSelector"] = selector
        if config_map:
            pod["volumes"] = [{"name": "config", "configMap": {"name": config_map}}]
        return {
            "apiVersion": "apps/v1", "kind": "Deployment", "metadata": _meta(name, deployment),
            "spec": {"replicas": svc.workers if rank is None else 1,
                     "selector": {"matchLabels": dict(labels)},
                     "template": {"metadata": {"labels": dict(labels)}, "spec": pod}},
        }

    return [one(rank) for rank in range(hosts)] if hosts > 1 else [one(None)]


def render_graph_manifests(manifest: ArtifactManifest, *, image: str,
                           deployment: str | None = None, http_port: int = 8080) -> list[dict]:
    """The whole set: coordinator, config, every component, and an HTTP
    Service in front of the graph's root service (last in
    ``discover_graph``'s dependencies-first order)."""
    deployment = deployment or manifest.name
    docs = render_coordinator(deployment, image)
    config_map = None
    if manifest.config_yaml:
        config_map = f"{deployment}-config"
        docs.append({"apiVersion": "v1", "kind": "ConfigMap",
                     "metadata": _meta(config_map, deployment),
                     "data": {CONFIG_FILE: manifest.config_yaml}})
    for svc in manifest.services:
        docs += render_component(svc, deployment, image, manifest.graph_target, config_map)
    front = f"{deployment}-{manifest.services[-1].name.lower()}"
    docs.append({"apiVersion": "v1", "kind": "Service",
                 "metadata": _meta(f"{deployment}-http", deployment),
                 "spec": {"selector": {"app.kubernetes.io/name": front},
                          "ports": [{"port": http_port, "targetPort": http_port}]}})
    return docs


def to_yaml(docs: list[dict]) -> str:
    """A multi-document YAML stream: each document as JSON, ``---``
    between them."""
    return "---\n".join(json.dumps(d, indent=2) + "\n" for d in docs)


def from_yaml(text: str) -> list[dict]:
    """The documents of a :func:`to_yaml` stream."""
    return [json.loads(chunk) for chunk in text.split("\n---\n") if chunk.strip()]
