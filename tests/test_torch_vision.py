"""The port's vision tower, the ``token_embeds`` seam and the multimodal
graph against the JAX package's.

- A tiny CLIP tower (JAX ``init_vision_params`` carried over by
  ``convert.vision_from_jax``) against JAX ``vision_forward`` at
  float32, ``feature_layer`` -1 and -2, and the projector's soft tokens
  against JAX ``encode_image`` (atol 1e-5: float32 both sides, only the
  summation order differs).
- A tiny ``CLIPVisionModel`` checkpoint written here with
  ``transformers`` and read by the port's own safetensors reader:
  ``last_hidden_state`` and ``hidden_states[-2]`` equal HF's (atol 2e-5,
  the JAX test's).
- ``token_embeds = embed[ids]`` gives the id path's logits bit for bit
  within the port (``forward`` and ``forward_ragged``), and JAX
  ``forward(token_embeds=...)``'s within atol 1e-4 at float32;
  ``forward_ragged(token_embeds=...)`` equals ``forward``.
- The EncodeWorker -> VisionChat flow in process, with the JAX
  services' weights carried over: the same ``n_image_tokens`` and
  ``next_token`` as the JAX graph.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_exp_tpu.models import TINY as JTINY
from dynamo_exp_tpu.models import init_params as jinit_params
from dynamo_exp_tpu.models import llama as jllama
from dynamo_exp_tpu.models import vision as jvision
from dynamo_exp_tpu_torch.models import TINY, convert, llama as tllama
from dynamo_exp_tpu_torch.models import vision as tvision

F32 = dataclasses.replace(TINY, dtype="float32")
JF32 = dataclasses.replace(JTINY, dtype="float32")
VCFG = dict(hidden_size=32, intermediate_size=64, num_layers=3, num_heads=4,
            image_size=16, patch_size=8, projector_dim=64)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _towers(feature_layer):
    jcfg = jvision.VisionConfig(**VCFG, feature_layer=feature_layer)
    tcfg = tvision.VisionConfig(**VCFG, feature_layer=feature_layer)
    params = _np(jvision.init_vision_params(jax.random.PRNGKey(3), jcfg))
    rs = np.random.RandomState(3)
    for name in ("ln1", "ln1_b", "ln2", "ln2_b", "wq_b", "w1_b", "pre_ln_b", "proj1_b"):
        params[name] = (params[name] + 0.1 * rs.standard_normal(params[name].shape)
                        ).astype(np.float32)
    tower = convert.vision_from_jax(params, tcfg, device="cpu")
    return jcfg, tcfg, params, tower


@pytest.mark.parametrize("feature_layer", [-1, -2])
def test_tower_matches_jax_vision_forward(feature_layer):
    jcfg, tcfg, params, tower = _towers(feature_layer)
    img = np.random.RandomState(1).rand(2, 16, 16, 3).astype(np.float32)
    want = np.asarray(jvision.vision_forward(jax.tree.map(jnp.asarray, params), jcfg, img))
    got = tvision.vision_forward(tower, tcfg, torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (2, 1 + tcfg.num_patches, 32)
    np.testing.assert_allclose(got, want, atol=1e-5)
    want_soft = np.asarray(jvision.encode_image(jax.tree.map(jnp.asarray, params), jcfg, img))
    got_soft = tvision.encode_image(tower, tcfg, torch.from_numpy(img)).numpy()
    assert got_soft.shape == (2, tcfg.num_patches, 64)
    np.testing.assert_allclose(got_soft, want_soft, atol=1e-5)


def test_vision_config_reads_llava_like_the_jax_package():
    llava = {"vision_config": {"hidden_size": 1024, "intermediate_size": 4096,
                               "num_hidden_layers": 24, "num_attention_heads": 16,
                               "image_size": 336, "patch_size": 14},
             "text_config": {"hidden_size": 4096}}
    for cfg in (llava, llava["vision_config"]):
        assert (dataclasses.asdict(tvision.VisionConfig.from_hf_config(cfg))
                == dataclasses.asdict(jvision.VisionConfig.from_hf_config(cfg)))
    tc = tvision.VisionConfig.from_hf_config(llava)
    assert tc == tvision.CLIP_VIT_L_336 and tc.num_patches == 576


def _hf_checkpoint(tmp_path, layers=3, image=16, seed=0):
    from transformers import CLIPVisionConfig, CLIPVisionModel

    torch.manual_seed(seed)
    model = CLIPVisionModel(CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=layers,
        num_attention_heads=4, image_size=image, patch_size=8)).eval()
    path = str(tmp_path / "clip")
    model.save_pretrained(path, safe_serialization=True)
    return model, path


def test_hf_clip_checkpoint_loads_through_the_port_reader(tmp_path):
    """The tensors transformers writes, read by ``models/loader.py``:
    ``last_hidden_state`` and LLaVA's ``hidden_states[-2]`` equal HF's."""
    model, path = _hf_checkpoint(tmp_path)
    tower, cfg = tvision.load_vision_params(path, device="cpu")
    assert tower.proj1 is None and cfg.projector_dim is None
    img = np.random.RandomState(0).rand(2, 16, 16, 3).astype(np.float32)
    with torch.no_grad():
        hf = model(pixel_values=torch.from_numpy(img.transpose(0, 3, 1, 2)),
                   output_hidden_states=True)
    got = tvision.vision_forward(tower, cfg, torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, hf.last_hidden_state.numpy(), atol=2e-5)
    cfg2 = dataclasses.replace(cfg, feature_layer=-2)
    got2 = tvision.vision_forward(tower, cfg2, torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got2, hf.hidden_states[-2].numpy(), atol=2e-5)
    # The JAX loader reads the same checkpoint to the same features.
    jparams, jcfg = jvision.load_vision_params(path)
    np.testing.assert_allclose(np.asarray(jvision.vision_forward(jparams, jcfg, img)), got,
                               atol=2e-5)


def test_encoder_attaches_a_projector_to_a_tower_only_checkpoint(tmp_path):
    from dynamo_exp_tpu_torch.examples.multimodal.components.encode_worker import (
        VisionEncoder,
    )

    _, path = _hf_checkpoint(tmp_path, layers=2, seed=1)
    enc = VisionEncoder(lm_hidden_size=64, model_path=path, device="cpu")
    out = enc(np.random.RandomState(2).rand(16, 16, 3))
    assert out.shape == (4, 64) and np.isfinite(out).all()
    # A picture of another size is resized onto the tower's raster.
    assert enc(np.random.RandomState(0).rand(32, 24, 3)).shape == (4, 64)


def _lm(seed=1):
    np_params = _np(jinit_params(jax.random.PRNGKey(seed), JF32))
    return np_params, convert.params_from_jax(np_params, F32, device="cpu")


TOKS = [3, 1, 4, 1, 5, 9, 2, 6]


def _forward(model, **kw):
    k, v = tllama.init_kv_cache(F32, 4, 8, torch.float32, device="cpu")
    out, _, _ = tllama.forward(model, F32, torch.tensor([TOKS]), torch.arange(8)[None],
                               torch.tensor([[1]], dtype=torch.int32), k, v,
                               attn_impl="reference", **kw)
    return out


def _ragged(model, **kw):
    k, v = tllama.init_kv_cache(F32, 4, 8, torch.float32, device="cpu")
    out, _, _ = tllama.forward_ragged(
        model, F32, torch.tensor(TOKS), torch.arange(8, dtype=torch.int32),
        torch.zeros(8, dtype=torch.int32), torch.tensor([[1]], dtype=torch.int32), k, v,
        torch.arange(8), attn_impl="reference", **kw)
    return out


def test_token_embeds_equal_the_id_path_and_jax():
    np_params, model = _lm()
    embeds = model.embed[torch.tensor(TOKS)]
    ids = _forward(model)
    soft = _forward(model, token_embeds=embeds[None])
    assert torch.equal(soft, ids)  # bit for bit within the port
    ragged_ids = _ragged(model)
    ragged_soft = _ragged(model, token_embeds=embeds)
    assert torch.equal(ragged_soft, ragged_ids)
    np.testing.assert_allclose(ragged_soft.numpy(), soft[0].numpy(), atol=1e-5)
    # JAX forward(token_embeds=...) on the same weights and soft tokens.
    jp = jax.tree.map(jnp.asarray, np_params)
    jk, jv = jllama.init_kv_cache(JF32, num_pages=4, page_size=8, dtype=jnp.float32)
    want, _, _ = jllama.forward(
        jp, JF32, jnp.zeros((1, 8), jnp.int32), jnp.arange(8, dtype=jnp.int32)[None],
        jnp.asarray([[1]], jnp.int32), jk, jv, token_embeds=jnp.asarray(embeds.numpy())[None])
    np.testing.assert_allclose(soft.numpy(), np.asarray(want), atol=1e-4)


def test_soft_embeds_through_forward_ragged_equal_forward():
    """Arbitrary soft tokens (not embedding rows): the flat mixed stream,
    padded to the kernel's q tile as ``soft_token_prefill`` pads it,
    gives ``forward``'s last-position logits."""
    from dynamo_exp_tpu_torch.examples.multimodal.multimodal_demo import soft_token_prefill

    _, model = _lm()
    feats = torch.from_numpy(np.random.RandomState(4).standard_normal((5, 64)).astype(
        np.float32))
    last, _, _, _, T = soft_token_prefill(model, F32, feats, [7, 8], attn_impl="reference")
    assert T == 7
    x = torch.cat([feats, model.embed[torch.tensor([7, 8])]])[None]
    k, v = tllama.init_kv_cache(F32, 4, 8, torch.float32, device="cpu")
    want, _, _ = tllama.forward(model, F32, torch.zeros(1, 7, dtype=torch.long),
                                torch.arange(7)[None], torch.tensor([[1]], dtype=torch.int32),
                                k, v, attn_impl="reference", token_embeds=x)
    np.testing.assert_allclose(last.numpy(), want[0, -1].numpy(), atol=1e-5)


def test_encode_worker_to_vision_chat_flow_matches_jax():
    """The demo graph in process (dependency wired by hand), the port's
    services given the JAX services' weights: the same image tokens and
    greedy token as the JAX graph."""
    from examples.multimodal.components.encode_worker import EncodeWorker as JEncode
    from examples.multimodal.multimodal_demo import VisionChat as JChat

    from dynamo_exp_tpu_torch.examples.multimodal.components.encode_worker import (
        EncodeWorker,
    )
    from dynamo_exp_tpu_torch.examples.multimodal.multimodal_demo import VisionChat

    def wire(chat_cls, enc):
        class _Dep:
            async def generate(self, request):
                async def gen():
                    async for item in enc.encode(request):
                        yield item

                return gen()

        chat_cls.encoder._client = _Dep()

    async def run(enc, chat, chat_cls, request):
        for svc in (enc, chat):
            await svc.build()
        wire(chat_cls, enc)
        try:
            return [item async for item in chat.generate(request)]
        finally:
            chat_cls.encoder._client = None

    img = np.random.RandomState(1).rand(16, 16, 3)
    request = {"pixels": img.tolist(), "token_ids": [5, 7, 9]}

    jenc, jchat = JEncode(), JChat()
    jenc.lm_hidden_size, jenc.image_size, jenc.patch = 64, 16, 8
    want = asyncio.run(run(jenc, jchat, JChat, request))

    enc, chat = EncodeWorker(), VisionChat()
    enc.lm_hidden_size, enc.image_size, enc.patch, enc.device = 64, 16, 8, "cpu"
    chat.device = "cpu"

    async def build_then_swap():
        await enc.build()
        await chat.build()
        enc.encoder.tower = convert.vision_from_jax(_np(jenc.encoder.params), enc.encoder.cfg,
                                                    device="cpu")
        chat.model = convert.params_from_jax(_np(jchat.params), chat.cfg, device="cpu")
        wire(VisionChat, enc)
        try:
            return [item async for item in chat.generate(request)]
        finally:
            VisionChat.encoder._client = None

    got = asyncio.run(build_then_swap())
    assert len(got) == len(want) == 1
    assert got[0]["n_image_tokens"] == want[0]["n_image_tokens"] == 4
    assert got[0]["next_token"] == want[0]["next_token"]
    assert 0 <= got[0]["next_token"] < TINY.vocab_size
