"""The LLM serving graphs: Frontend -> Processor -> CudaWorker, with or
without KV routing and a remote-prefill fleet (counterpart of
``examples/llm/``). Serve one with ``python -m
dynamo_exp_tpu_torch.sdk.serve
dynamo_exp_tpu_torch.examples.llm.graphs.agg:Frontend -f
dynamo_exp_tpu_torch/examples/llm/configs/agg.json --start-coordinator``.
"""
