"""Deploy tier: artifact build, artifact and deployment store, K8s
rendering, the reconciling operator.

Counterpart of ``dynamo_exp_tpu/deploy/``: artifacts are
content-addressed tarballs of an SDK graph and its sources (the port's
also carry its kernels' sources), the api-store keeps them and the
deployment records, rendering targets GKE GPU node pools
(``nvidia.com/gpu`` limits, the ``cloud.google.com/gke-accelerator``
selector) with the self-hosted coordinator as the control plane, and
the operator reconciles the records against a cluster. Manifests are
JSON documents in a YAML stream; the port imports no YAML library.
"""

from .artifact import ArtifactManifest, build_artifact, read_manifest
from .k8s import from_yaml, render_graph_manifests, to_yaml

__all__ = [
    "ArtifactManifest",
    "build_artifact",
    "from_yaml",
    "read_manifest",
    "render_graph_manifests",
    "to_yaml",
]
