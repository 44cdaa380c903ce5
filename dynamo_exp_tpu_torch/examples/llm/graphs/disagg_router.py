"""Disaggregated serving with KV-aware routing: the full fleet shape.

Counterpart of ``examples/llm/graphs/disagg_router.py``. Two routing
layers compose here:

- the Processor's KV router (``router: kv`` in the config) picks the
  decode worker with the longest cached prefix;
- each decode worker's conditional disagg router (a live-watched
  ``DisaggConfig``; retune it with ``llmctl disagg set <model>
  --max-local-prefill-length N``) decides per request whether the
  prefill runs locally or on the prefill fleet.

    python -m dynamo_exp_tpu_torch.sdk.serve \
        dynamo_exp_tpu_torch.examples.llm.graphs.disagg_router:Graph \
        -f dynamo_exp_tpu_torch/examples/llm/configs/disagg_router.json --start-coordinator
"""

from dynamo_exp_tpu_torch.examples.llm.components.frontend import Frontend
from dynamo_exp_tpu_torch.examples.llm.components.prefill_worker import PrefillCudaWorker
from dynamo_exp_tpu_torch.examples.llm.components.processor import Processor
from dynamo_exp_tpu_torch.examples.llm.components.worker import CudaWorker
from dynamo_exp_tpu_torch.sdk import depends, service


@service(dynamo={"namespace": "dynamo"})
class Graph:
    """Root tying the HTTP ingress to both fleets (edges for graph
    discovery; neither client is ever called)."""

    frontend = depends(Frontend)
    prefill = depends(PrefillCudaWorker, endpoint="pull")


__all__ = ["Graph", "Frontend", "Processor", "CudaWorker", "PrefillCudaWorker"]
