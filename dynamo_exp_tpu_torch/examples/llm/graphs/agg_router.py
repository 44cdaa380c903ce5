"""Aggregated serving with KV-aware routing.

Counterpart of ``examples/llm/graphs/agg_router.py`` (Frontend ->
Processor -> Router -> Worker): the KV router lives in the Processor
(``router: kv`` in the config selects it), fed by the KV events the
worker fleet publishes.

    python -m dynamo_exp_tpu_torch.sdk.serve \
        dynamo_exp_tpu_torch.examples.llm.graphs.agg_router:Frontend \
        -f dynamo_exp_tpu_torch/examples/llm/configs/agg_router.json --start-coordinator
"""

from dynamo_exp_tpu_torch.examples.llm.components.frontend import Frontend
from dynamo_exp_tpu_torch.examples.llm.components.processor import Processor
from dynamo_exp_tpu_torch.examples.llm.components.worker import CudaWorker

__all__ = ["Frontend", "Processor", "CudaWorker"]
