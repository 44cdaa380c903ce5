"""``chip_smoke.py``'s phase 17 rehearsed on the CPU at a small size: a
llama config at TINY's widths (a vocabulary of 1,024 Unigram pieces,
2 layers) written as a GGUF in all four encodings with its tokenizer
and Mistral's chat template embedded, served by
``run.main_async(in=http out=cuda --device cpu --model-path x.gguf)``:
weights bit-equal to the file's decoding, 8 streamed chats with exact
usage and a rerun of the same text; then the same model as
config.json + ``tokenizer.model`` + bf16 safetensors: the same prompt
ids and the same tokens. Also: the smoke's ``tokenizer.model`` and its
GGUF vocabulary give the JAX package's ids."""

from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import torch

import chip_smoke as cs
import dynamo_exp_tpu_torch as pkg
import dynamo_exp_tpu_torch.engine  # noqa: F401
import dynamo_exp_tpu_torch.models  # noqa: F401
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.ops import ragged_attention as tra

SMALL = replace(TINY, vocab_size=1024, head_dim=16, rope_theta=1e6,
                rms_norm_eps=float(np.float32(1e-5)), model_type="llama")


def test_smoke_phase17_on_cpu():
    sh = cs.Phase17(device="cpu", layers=2, max_tokens=8, chat_chars=600)
    out = cs.phase17(torch, np, pkg, tra, "cpu", sh=sh, mcfg=SMALL)
    a, b = out["a"], out["b"]
    assert a["tokens"] == b["tokens"] and all(len(t) == 8 for t in a["tokens"])
    assert len(a["texts"]) == 8 and out["bytes"] > 0 and out["load_s"] > 0


def test_smoke_vocabulary_reads_like_the_jax_package(tmp_path):
    """The smoke's pieces as a GGUF vocabulary and as a
    ``tokenizer.model``: the port's ids equal HF ``tokenizers``' (through
    the JAX package) on README text, CJK and emoji."""
    from dynamo_exp_tpu.gguf_tokenizer import tokenizer_backend_from_gguf as j_from_gguf
    from dynamo_exp_tpu.sp_model import tokenizer_backend_from_sp as j_from_sp
    from dynamo_exp_tpu_torch.gguf_tokenizer import tokenizer_backend_from_gguf
    from dynamo_exp_tpu_torch.sp_model import tokenizer_backend_from_sp

    with open(cs.os.path.join(cs.HERE, "README.md"), encoding="utf-8") as f:
        text = f.read()
    pieces = cs.unigram_pieces(text, 4096, seed=17)
    assert len(pieces) == len({p for p, _, _ in pieces}) == 4096
    md = {"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": [p for p, _, _ in pieces],
          "tokenizer.ggml.scores": [s for _, s, _ in pieces],
          "tokenizer.ggml.token_type": [k for _, _, k in pieces],
          "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2,
          "tokenizer.ggml.unknown_token_id": 0}
    path = tmp_path / "tokenizer.model"
    path.write_bytes(cs.sp_model_bytes(pieces))
    pairs = [(j_from_gguf(SimpleNamespace(metadata=md)),
              tokenizer_backend_from_gguf(SimpleNamespace(metadata=md))),
             (j_from_sp(str(path)), tokenizer_backend_from_sp(str(path)))]
    for s in (text[:4000], "[INST] 日本語 ☃🎉 [/INST]", "  doubled  spaces "):
        want = pairs[0][0].encode(s).ids
        for jb, tb in pairs:
            assert jb.encode(s).ids == want and tb.encode(s) == want, s
    assert any(t.startswith("<0x") for t in pairs[0][0].encode("日本語").tokens)
