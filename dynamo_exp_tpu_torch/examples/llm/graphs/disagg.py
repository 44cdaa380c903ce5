"""Disaggregated serving: a decode fleet and a remote prefill fleet.

Counterpart of ``examples/llm/graphs/disagg.py`` (Frontend -> Processor
-> Worker, PrefillWorker): the decode worker's ``disagg_mode: decode``
sends long uncached prefills through the work queue to the prefill
fleet; their KV pages come back over the TCP transfer plane.

    python -m dynamo_exp_tpu_torch.sdk.serve \
        dynamo_exp_tpu_torch.examples.llm.graphs.disagg:Graph \
        -f dynamo_exp_tpu_torch/examples/llm/configs/disagg.json --start-coordinator
"""

from dynamo_exp_tpu_torch.examples.llm.components.frontend import Frontend
from dynamo_exp_tpu_torch.examples.llm.components.prefill_worker import PrefillCudaWorker
from dynamo_exp_tpu_torch.examples.llm.components.processor import Processor
from dynamo_exp_tpu_torch.examples.llm.components.worker import CudaWorker
from dynamo_exp_tpu_torch.sdk import depends, service


@service(dynamo={"namespace": "dynamo"})
class Graph:
    """Root tying the HTTP ingress to both fleets. The edges exist for
    graph discovery (the serve CLI launches the dependency closure);
    neither client is ever called."""

    frontend = depends(Frontend)
    prefill = depends(PrefillCudaWorker, endpoint="pull")


__all__ = ["Graph", "Frontend", "Processor", "CudaWorker", "PrefillCudaWorker"]
