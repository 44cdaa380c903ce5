"""``chip_smoke.py``'s phase 20 rehearsed on the CPU at a small size:
the deploy CLI builds, renders, pushes and deploys the port's agg_router
graph (``device: cpu``, 2 layers, narrow widths, two CudaWorkers), the
operator applies the rendered documents once and then nothing, the
rendered commands run as processes with only the unpacked artifact on
``PYTHONPATH``, and they serve (a) a burst and two identical runs one
request at a time; (b) the router service and the metrics exporter
beside them answer as the fleet's KV events and loads say. Every
process exits 0 on SIGTERM and the operator collects the documents. The
kernel-launch checks are the card's only. The phase's kubelet gives a
gpu pod the card the smoke was given and maps every rendered Service
port to a free host port."""

import json
from dataclasses import replace

import numpy as np
import pytest
import torch

import chip_smoke as cs
import dynamo_exp_tpu_torch as pkg
import dynamo_exp_tpu_torch.engine  # noqa: F401
from dynamo_exp_tpu_torch.deploy.artifact import ArtifactManifest, ServiceManifest
from dynamo_exp_tpu_torch.deploy.k8s import COORDINATOR_PORT, render_graph_manifests
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.ops import ragged_attention as tra

SMALL = replace(TINY, vocab_size=1024, hidden_size=128, intermediate_size=256, num_layers=2,
                max_position_embeddings=1024)
# Prompts of distinct 16-token block counts (a routing decision names its
# prompt by them), as phase 5's are.
SH = cs.Phase20(device="cpu", prompt_lens=(24, 40, 56, 72, 88, 104, 120, 136), max_tokens=8,
                num_pages=96, slots=4, max_model_len=256, boot_s=120.0)


def test_smoke_phase20_on_cpu():
    out = cs.phase20(torch, np, pkg, tra, "cpu", sh=SH, mcfg=SMALL)
    assert out["overlaps"] and all(o > 0 for o in out["overlaps"])
    assert out["a"]["tokens_per_s"] > 0 and out["b"]["tokens_per_s"] > 0


def _rendered():
    """Phase 20's documents for a manifest of its graph, and its config."""
    cfg = cs._p20_graph_cfg(SH, "/model", 8080)
    man = ArtifactManifest(name="d", graph_target=cs.P20_GRAPH, services=[
        ServiceManifest("CudaWorker", "dynamo", 2, {"gpu": 1}, ["generate"]),
        ServiceManifest("Processor", "dynamo", 1, {}, ["generate"], ["CudaWorker"]),
        ServiceManifest("Frontend", "dynamo", 1, {}, [], ["Processor"])],
        config_yaml=json.dumps(cfg))
    return (lambda: render_graph_manifests(man, image="img", deployment="d")), cfg


def _kubelet(tmp_path, docs, cfg):
    return cs._Kubelet(docs, str(tmp_path / "root"), {"d-config": str(tmp_path / "etc")}, cfg)


@pytest.mark.parametrize("visible, card", [("2,3", "2"), ("GPU-a,GPU-b", "GPU-a"), (None, "0")])
def test_kubelet_gives_a_gpu_pod_the_smokes_first_card(tmp_path, monkeypatch, visible, card):
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    render, cfg = _rendered()
    docs = render()
    kube = _kubelet(tmp_path, docs, cfg)
    by_name = {d["metadata"]["name"]: d for d in docs if d["kind"] == "Deployment"}
    _, env = kube.spec(by_name["d-cudaworker"])
    # Both workers' slots are the pod's one card, which is the smoke's.
    assert (env["CUDA_VISIBLE_DEVICES"], env["DYN_CUDA_DEVICES"]) == (card, "0,0")
    _, env = kube.spec(by_name["d-processor"])
    assert "CUDA_VISIBLE_DEVICES" not in env


def test_kubelet_maps_every_service_port_to_a_free_host_port(tmp_path):
    render, cfg = _rendered()
    docs = render()
    kube = _kubelet(tmp_path, docs, cfg)
    by_name = {d["metadata"]["name"]: d for d in docs if d["kind"] == "Deployment"}
    cmd, _ = kube.spec(by_name["d-coordinator"])
    coord = int(cmd[cmd.index("--port") + 1])
    assert coord != COORDINATOR_PORT
    assert kube.resolve(f"d-coordinator:{COORDINATOR_PORT}") == f"127.0.0.1:{coord}"
    for name in ("d-cudaworker", "d-processor", "d-frontend"):
        assert kube.spec(by_name[name])[1]["DYN_COORDINATOR"] == f"127.0.0.1:{coord}"
    # The Frontend listens where the HTTP Service's port resolves; the
    # rest of the mounted config is the artifact's.
    with open(tmp_path / "etc" / "config.json", encoding="utf-8") as f:
        written = json.load(f)
    http = int(kube.resolve("d-http:8080").rsplit(":", 1)[1])
    assert written["Frontend"]["port"] == http and http not in (8080, coord)
    assert {k: v for k, v in written.items() if k != "Frontend"} == {
        k: v for k, v in cfg.items() if k != "Frontend"}
    # The rendered documents and the smoke's config stay as they were.
    assert docs == render() and cfg["Frontend"]["port"] == 8080
    assert kube.resolve("elsewhere:6650") == "elsewhere:6650"
