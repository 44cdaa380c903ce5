"""The port's deploy tier (``dynamo_exp_tpu_torch/deploy/``) against the
JAX package's, on the CPU.

The stated mapping from a JAX graph to the port's: the service
``TpuWorker`` is ``CudaWorker`` (``PrefillTpuWorker`` is
``PrefillCudaWorker``), ``resources={"tpu": n}`` is ``{"gpu": n}``,
``tpu_hosts`` is ``gpu_hosts``, module paths ``dynamo_exp_tpu.`` and
``examples.`` are ``dynamo_exp_tpu_torch.`` and
``dynamo_exp_tpu_torch.examples.``, the config file ``config.yaml`` (YAML)
is ``config.json`` (JSON of the same data), the managed-by label
``dynamo-exp-tpu`` is ``dynamo-exp-tpu-torch``, a ``google.com/tpu``
limit is an ``nvidia.com/gpu`` one, and the TPU accelerator and topology
selectors are the one ``cloud.google.com/gke-accelerator`` selector
(``nvidia-h100-80gb``). Under it:

- every graph's artifact manifest equals the JAX one's, and a build is
  content-addressed and carries the kernels' sources;
- the rendered documents equal the JAX documents (multi-node ranks
  too), and ``to_yaml``'s text parses (PyYAML, here only) back to them;
- the api-store, the CLI and the operator go through the lifecycles of
  ``tests/test_deploy.py`` (a fake ``kubectl`` program for
  ``KubectlBackend``);
- the api-store's process serves on the plain HTTP wire without
  importing torch.
"""

import json
import os
import stat
import subprocess
import sys
import tarfile

import pytest
import yaml

from dynamo_exp_tpu import deploy as jdeploy
from dynamo_exp_tpu_torch import deploy as tdeploy
from dynamo_exp_tpu_torch.deploy.api_store import ApiStore
from dynamo_exp_tpu_torch.deploy.cli import main as deploy_cli
from dynamo_exp_tpu_torch.deploy.operator import (
    DeploymentOperator,
    KubectlBackend,
    MemoryBackend,
)
from dynamo_exp_tpu_torch.http import client

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPHS = ["agg", "agg_router", "disagg", "disagg_router"]
PORT_GRAPH = "dynamo_exp_tpu_torch.examples.llm.graphs.{}:Frontend"
JAX_GRAPH = "examples.llm.graphs.{}:Frontend"
PORT_CONFIG = os.path.join(REPO, "dynamo_exp_tpu_torch/examples/llm/configs/{}.json")
JAX_CONFIG = os.path.join(REPO, "examples/llm/configs/{}.yaml")
SERVICES = {"TpuWorker": "CudaWorker", "PrefillTpuWorker": "PrefillCudaWorker"}
MAPPING = [
    ("dynamo_exp_tpu.", "dynamo_exp_tpu_torch."),
    ('"examples.llm', '"dynamo_exp_tpu_torch.examples.llm'),
    ("config.yaml", "config.json"),
    ('"dynamo-exp-tpu"', '"dynamo-exp-tpu-torch"'),
    ("google.com/tpu", "nvidia.com/gpu"),
    ("PrefillTpuWorker", "PrefillCudaWorker"),
    ("prefilltpuworker", "prefillcudaworker"),
    ("TpuWorker", "CudaWorker"),
    ("tpuworker", "cudaworker"),
]


def _jax_manifest(graph: str):
    return jdeploy.artifact.manifest_for_graph(JAX_GRAPH.format(graph),
                                               config_path=JAX_CONFIG.format(graph))


def _port_manifest(graph: str):
    return tdeploy.artifact.manifest_for_graph(PORT_GRAPH.format(graph),
                                               config_path=PORT_CONFIG.format(graph))


def _config_data(manifest, loads) -> dict:
    data = loads(manifest.config_yaml)
    return {SERVICES.get(k, k): v for k, v in data.items()}


def _mapped(jax_docs: list[dict]) -> list[dict]:
    """The JAX documents under the stated mapping (ConfigMap data aside:
    its text is YAML there and JSON here, compared as data)."""
    text = json.dumps(jax_docs)
    for a, b in MAPPING:
        text = text.replace(a, b)
    docs = json.loads(text)
    for d in docs:
        pod = d.get("spec", {}).get("template", {}).get("spec", {})
        if "nodeSelector" in pod:
            pod["nodeSelector"] = {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
        if d["kind"] == "ConfigMap":
            d["data"] = {"config.json": None}
    return docs


def _without_config_text(docs: list[dict]) -> list[dict]:
    out = json.loads(json.dumps(docs))
    for d in out:
        if d["kind"] == "ConfigMap":
            d["data"] = {k: None for k in d["data"]}
    return out


@pytest.mark.parametrize("graph", GRAPHS)
def test_manifest_equals_jax_under_the_mapping(graph):
    jm, tm = _jax_manifest(graph), _port_manifest(graph)
    assert tm.graph_target == "dynamo_exp_tpu_torch." + jm.graph_target
    assert tm.name == jm.name
    want = []
    for s in jm.services:
        res = {("gpu" if k == "tpu" else k): v for k, v in s.resources.items()}
        want.append((SERVICES.get(s.name, s.name), s.namespace, s.workers, res, s.endpoints,
                     [SERVICES.get(n, n) for n in s.depends_on]))
    assert [(s.name, s.namespace, s.workers, s.resources, s.endpoints, s.depends_on)
            for s in tm.services] == want
    assert _config_data(tm, json.loads) == _config_data(jm, yaml.safe_load)


@pytest.mark.parametrize("graph", GRAPHS)
def test_rendered_documents_equal_jax_under_the_mapping(graph):
    jm, tm = _jax_manifest(graph), _port_manifest(graph)
    jdocs = jdeploy.render_graph_manifests(jm, image="img:1", deployment="d1")
    tdocs = tdeploy.render_graph_manifests(tm, image="img:1", deployment="d1")
    assert _without_config_text(tdocs) == _mapped(jdocs)
    cm = next(d for d in tdocs if d["kind"] == "ConfigMap")
    assert json.loads(cm["data"]["config.json"]) == json.loads(tm.config_yaml)
    # The YAML stream is JSON documents: PyYAML reads back the documents.
    text = tdeploy.to_yaml(tdocs)
    assert list(yaml.safe_load_all(text)) == tdocs == tdeploy.from_yaml(text)
    worker = next(d for d in tdocs if d["metadata"]["name"] == "d1-cudaworker")
    c = worker["spec"]["template"]["spec"]["containers"][0]
    assert c["resources"] == {"limits": {"nvidia.com/gpu": "1"}}
    assert c["command"][:3] == ["python", "-m", "dynamo_exp_tpu_torch.sdk.serve"]
    assert c["command"][-2:] == ["-f", "/etc/dynamo/config.json"]


@pytest.mark.parametrize("hosts,accel", [(2, None), (3, "nvidia-h200-141gb")])
def test_multinode_ranks_equal_jax_under_the_mapping(hosts, accel):
    jm, tm = _jax_manifest("agg"), _port_manifest("agg")
    next(s for s in jm.services if s.name == "TpuWorker").resources = {
        "tpu": 4, "tpu_hosts": hosts}
    res = {"gpu": 4, "gpu_hosts": hosts}
    if accel:
        res["gpu_accelerator"] = accel
    next(s for s in tm.services if s.name == "CudaWorker").resources = res
    jdocs = jdeploy.render_graph_manifests(jm, image="img", deployment="mh")
    tdocs = tdeploy.render_graph_manifests(tm, image="img", deployment="mh")
    want = _mapped(jdocs)
    if accel:
        for d in want:
            pod = d.get("spec", {}).get("template", {}).get("spec", {})
            if "nodeSelector" in pod:
                pod["nodeSelector"] = {"cloud.google.com/gke-accelerator": accel}
    assert _without_config_text(tdocs) == want
    ranks = [d for d in tdocs if d["metadata"]["name"].startswith("mh-cudaworker-")]
    assert len(ranks) == hosts
    for r, d in enumerate(ranks):
        cmd = d["spec"]["template"]["spec"]["containers"][0]["command"]
        assert cmd[cmd.index("--node-rank") + 1] == str(r) and "--deployment" in cmd


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("art") / "agg.tar.gz")
    manifest = tdeploy.build_artifact(PORT_GRAPH.format("agg"), out,
                                      config_path=PORT_CONFIG.format("agg"), src_root=REPO)
    return out, manifest


def test_build_is_content_addressed_and_packs_the_kernel_sources(artifact, tmp_path):
    path, manifest = artifact
    assert len(manifest.version) == 16
    again = tdeploy.build_artifact(PORT_GRAPH.format("agg"), str(tmp_path / "b.tar.gz"),
                                   config_path=PORT_CONFIG.format("agg"), src_root=REPO)
    assert again.version == manifest.version
    other = tdeploy.build_artifact(PORT_GRAPH.format("agg"), str(tmp_path / "c.tar.gz"),
                                   src_root=REPO)  # no config: another manifest
    assert other.version != manifest.version
    assert tdeploy.read_manifest(path).version == manifest.version
    with tarfile.open(path) as tar:
        names = tar.getnames()
    for src in ("csrc/ragged_mixed_tc.cu", "csrc/ragged_decode_split.cu",
                "csrc/ragged_attention.cu", "csrc/common.cuh", "native/blockhash.cpp",
                "examples/llm/graphs/agg.py", "examples/llm/configs/agg.json"):
        assert f"dynamo_exp_tpu_torch/{src}" in names
    assert not [n for n in names if "/_build/" in n or "__pycache__" in n]


async def test_api_store_artifact_and_deployment_lifecycle(tmp_path, artifact):
    path, manifest = artifact
    store = ApiStore(str(tmp_path / "store"))
    addr = await store.start()
    try:
        with open(path, "rb") as f:
            r = await client.request(f"{addr}/api/v1/artifacts", "POST", f.read())
        assert r.status == 200
        assert r.json() == {"name": manifest.name, "version": manifest.version}
        r = await client.request(f"{addr}/api/v1/artifacts")
        assert [a["name"] for a in r.json()] == [manifest.name]

        r = await client.request(f"{addr}/api/v1/deployments", "POST", {
            "artifact": manifest.name, "version": manifest.version, "image": "img:2",
            "name": "prod"})
        assert r.status == 200
        assert r.json() == {"name": "prod", "services": [s.name for s in manifest.services]}
        rec = (await client.request(f"{addr}/api/v1/deployments/prod")).json()
        assert rec["image"] == "img:2"
        docs = list(yaml.safe_load_all(rec["manifests_yaml"]))
        assert any(d["metadata"]["name"] == "prod-coordinator" for d in docs)
        r = await client.request(f"{addr}/api/v1/deployments")
        assert r.json() == [{"name": "prod", "artifact": manifest.name,
                             "version": manifest.version}]

        r = await client.request(f"{addr}/api/v1/artifacts/{manifest.name}/{manifest.version}")
        dl = tmp_path / "dl.tar.gz"
        dl.write_bytes(r.body)
        assert tdeploy.read_manifest(str(dl)).version == manifest.version

        assert (await client.request(f"{addr}/api/v1/deployments/prod", "DELETE")).status == 200
        assert (await client.request(f"{addr}/api/v1/deployments/prod")).status == 404
        r = await client.request(f"{addr}/api/v1/deployments", "POST",
                                 {"artifact": "nope", "version": "0"})
        assert r.status == 404 and r.json() == {"error": "artifact not in store"}
        r = await client.request(f"{addr}/api/v1/artifacts", "POST", b"junk")
        assert r.status == 400  # not stored
        r = await client.request(
            f"{addr}/api/v1/artifacts/{manifest.name}/{manifest.version}", "DELETE")
        assert r.status == 200 and (await client.request(f"{addr}/api/v1/artifacts")).json() == []
    finally:
        await store.close()


def test_deploy_cli_build_and_render(tmp_path, capsys):
    out = str(tmp_path / "cli.tar.gz")
    assert deploy_cli(["build", PORT_GRAPH.format("agg_router"), "-o", out,
                       "-f", PORT_CONFIG.format("agg_router"), "--src-root", REPO]) == 0
    built = json.loads(capsys.readouterr().out)
    assert built["services"] == ["CudaWorker", "Processor", "Frontend"]
    assert deploy_cli(["render", out, "--image", "x:y", "--deployment", "dd"]) == 0
    docs = list(yaml.safe_load_all(capsys.readouterr().out))
    assert any(d["metadata"]["name"] == "dd-coordinator" for d in docs)
    assert docs == tdeploy.render_graph_manifests(tdeploy.read_manifest(out), image="x:y",
                                                  deployment="dd")


async def test_deploy_cli_push_list_and_deploy(tmp_path, artifact, capsys):
    import asyncio

    path, manifest = artifact
    store = ApiStore(str(tmp_path / "store"))
    addr = await store.start()

    def cli(*argv):  # the CLI runs its own event loop: off this one
        return asyncio.to_thread(deploy_cli, list(argv))

    try:
        assert await cli("push", path, "--store", addr) == 0
        assert json.loads(capsys.readouterr().out)["version"] == manifest.version
        assert await cli("list", "--store", addr) == 0
        assert [a["version"] for a in json.loads(capsys.readouterr().out)] == [manifest.version]
        assert await cli("deploy", manifest.name, manifest.version, "--store", addr,
                         "--deployment", "blue") == 0
        assert json.loads(capsys.readouterr().out)["name"] == "blue"
        assert await cli("deploy", "nope", "0", "--store", addr) == 1
    finally:
        await store.close()


async def test_operator_reconciles_applies_and_finalizes(tmp_path, artifact):
    """Create -> applied and Ready; a second pass applies nothing; drift
    -> re-applied; a replica override -> patched; unreadiness ->
    Deploying; the record deleted -> every resource collected."""
    path, manifest = artifact
    store = ApiStore(str(tmp_path / "store"))
    addr = await store.start()
    backend = MemoryBackend()
    op = DeploymentOperator(str(tmp_path / "store"), backend, interval_s=0.05)
    rec_path = tmp_path / "store/deployments/prod.json"
    try:
        with open(path, "rb") as f:
            assert (await client.request(f"{addr}/api/v1/artifacts", "POST",
                                         f.read())).status == 200
        r = await client.request(f"{addr}/api/v1/deployments", "POST", {
            "name": "prod", "artifact": manifest.name, "version": manifest.version})
        assert r.status == 200

        results = await op.reconcile_all()
        assert results["prod"].phase == "Ready"
        applied = backend.applied["prod"]
        rendered = tdeploy.from_yaml(json.loads(rec_path.read_text())["manifests_yaml"])
        assert results["prod"].applied == len(rendered) == len(applied)
        assert list(applied.values()) == rendered
        rec = json.loads(rec_path.read_text())
        assert rec["status"]["phase"] == "Ready" and all(rec["status"]["services_ready"].values())

        results = await op.reconcile_all()
        assert results["prod"].applied == 0 and results["prod"].deleted == 0

        key = next(k for k in applied if k[0] == "Deployment")
        backend.applied["prod"][key] = {"kind": "Deployment", "metadata": {"name": key[1]},
                                        "tampered": True}
        assert (await op.reconcile_all())["prod"].applied == 1
        assert "tampered" not in backend.applied["prod"][key]

        rec = json.loads(rec_path.read_text())
        svc = next(k[1] for k in applied if k[0] == "Deployment")
        rec["services_spec"] = {svc.split("-")[-1]: {"replicas": 3}}
        rec_path.write_text(json.dumps(rec))
        await op.reconcile_all()
        assert backend.applied["prod"][("Deployment", svc)]["spec"]["replicas"] == 3

        backend.ready_keys.discard(("prod", key))
        assert (await op.reconcile_all())["prod"].phase == "Deploying"
        backend.ready_keys.add(("prod", key))

        assert (await client.request(f"{addr}/api/v1/deployments/prod", "DELETE")).status == 200
        await op.reconcile_all()
        assert backend.applied.get("prod", {}) == {}
    finally:
        await op.close()
        await store.close()


FAKE_KUBECTL = '''#!{python}
"""kubectl, simulated over a JSON file: apply (JSON on stdin), get by
label or by name, delete; every call appended to the log."""
import json, os, sys
state = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cluster.json")
cluster = json.load(open(state)) if os.path.exists(state) else {{}}
args = sys.argv[3:]  # after "-n <namespace>"
with open(state + ".log", "a") as log:
    log.write(json.dumps(args) + "\\n")
if args[0] == "apply":
    doc = json.loads(sys.stdin.read())
    cluster[doc["kind"] + "/" + doc["metadata"]["name"]] = doc
elif args[0] == "get" and "-l" in args:
    items = [d for k, d in cluster.items() if k.split("/")[0].lower() == args[1]]
    print(json.dumps({{"items": items}}))
elif args[0] == "get":
    doc = cluster[args[1].capitalize() + "/" + args[2]]
    print(json.dumps({{**doc, "status": {{"availableReplicas": doc["spec"]["replicas"]}}}}))
elif args[0] == "delete":
    cluster.pop(args[1].capitalize() + "/" + args[2], None)
else:
    sys.exit("unexpected kubectl arguments: %r" % args)
json.dump(cluster, open(state, "w"))
'''


async def test_kubectl_backend_second_reconcile_applies_nothing(tmp_path):
    """Through a fake ``kubectl`` program: JSON on its stdin, the owner
    labels and the hash of the document as rendered, so that a second
    pass applies nothing; the record's deletion removes both."""
    kubectl = tmp_path / "bin" / "kubectl"
    kubectl.parent.mkdir()
    kubectl.write_text(FAKE_KUBECTL.format(python=sys.executable))
    kubectl.chmod(kubectl.stat().st_mode | stat.S_IEXEC)
    docs = [
        {"kind": "Deployment", "apiVersion": "apps/v1",
         "metadata": {"name": "d1-app", "labels": {"app.kubernetes.io/name": "d1-app"}},
         "spec": {"replicas": 1}},
        {"kind": "Service", "apiVersion": "v1", "metadata": {"name": "d1-app"},
         "spec": {"ports": [{"port": 80}]}},
    ]
    ddir = tmp_path / "store" / "deployments"
    os.makedirs(ddir)
    (ddir / "d1.json").write_text(json.dumps({"name": "d1",
                                              "manifests_yaml": tdeploy.to_yaml(docs)}))
    backend = KubectlBackend(kubectl=str(kubectl))
    op = DeploymentOperator(str(tmp_path / "store"), backend, interval_s=0.05)
    state = tmp_path / "bin" / "cluster.json"
    applies = lambda: sum('"apply"' in x for x in open(str(state) + ".log"))  # noqa: E731

    results = await op.reconcile_all()
    assert results["d1"].phase == "Ready" and results["d1"].applied == 2 and applies() == 2
    dep = json.loads(state.read_text())["Deployment/d1-app"]
    assert dep["metadata"]["labels"]["dynamo-exp-tpu-torch/deployment"] == "d1"
    assert dep["metadata"]["labels"]["app.kubernetes.io/managed-by"] == (
        "dynamo-exp-tpu-torch-operator")
    assert backend.HASH_ANNOTATION == "dynamo-exp-tpu-torch/content-hash"
    assert backend.HASH_ANNOTATION in dep["metadata"]["annotations"]

    results = await op.reconcile_all()
    assert results["d1"].applied == 0 and results["d1"].deleted == 0 and applies() == 2

    os.unlink(ddir / "d1.json")
    await op.reconcile_all()
    assert json.loads(state.read_text()) == {}


def test_api_store_process_imports_no_torch():
    """The store is a control-plane process: ``http/wire.py`` and the
    lazy ``http`` package keep the OpenAI pipeline, and torch, out of it."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", "import sys, dynamo_exp_tpu_torch.deploy.api_store; "
         "print(sorted(m for m in ('torch', 'numpy') if m in sys.modules))"],
        cwd=root, env=dict(os.environ, PYTHONPATH=root), capture_output=True, text=True,
        check=True, timeout=120)
    assert out.stdout.strip() == "[]"
