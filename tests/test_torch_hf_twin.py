"""The port's parity tier against the HF torch twin, the JAX package's parity
contract (``tests/test_vla_e2e.py``), on the CPU at tiny size.

The twin is built as ``tests/test_vla_e2e.py`` builds it: random-init HF
``LlamaForCausalLM`` (eager attention), ``Dinov2WithRegistersModel`` and
``SiglipVisionModel`` modules (no download), their weights mapped into the
JAX package's layout by ``tests/hf_convert.py`` and ``llama.params_from_hf``,
and from there into the port's by ``convert.params_from_jax``; the
projector's weights go the other way into a torch ``nn.Sequential``. The
twin runs the reference's serving semantics from spec (second-to-last block
features, channel concat, projector, splice after BOS, a full forward per
greedy step over the whole vocab). The port runs
``predict_action_from_image`` on a uint8 image, and the twin takes the
pixels the port's own image transform makes of it (that transform is held
to the JAX package's in ``tests/test_torch_image.py``).

Action tokens equal; actions within 1e-5 (the same tokens decode to the same
bin centers; un-normalization in fp32).
"""

import jax
import numpy as np
import pytest
import torch

from openvla_probe_tpu.models import llama as jllama
from openvla_probe_tpu.models import projector as jprojector
from openvla_probe_tpu.models import vit as jvit
from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import vla as tvla
from openvla_probe_tpu_torch.ops.image import (BackboneTransformSpec, ImageTransformConfig,
                                               apply_image_transform)
from openvla_probe_tpu_torch.vla.action_tokenizer import ActionCodec

from tests.hf_convert import dinov2_to_params, projector_params_to_torch, siglip_to_params

VOCAB = 512
A_DIM = 7
IMG_CFG = ImageTransformConfig(specs=(
    BackboneTransformSpec((28, 28), "bicubic", (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    BackboneTransformSpec((28, 28), "bicubic", (0.5, 0.5, 0.5), (0.5, 0.5, 0.5))))


@pytest.fixture(scope="module")
def twin():
    from transformers import (Dinov2WithRegistersConfig, Dinov2WithRegistersModel,
                              LlamaConfig as HFLlamaConfig, LlamaForCausalLM,
                              SiglipVisionConfig, SiglipVisionModel)

    with torch.random.fork_rng():
        torch.manual_seed(7)
        hf_llama = LlamaForCausalLM(HFLlamaConfig(
            vocab_size=VOCAB, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
            num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=256,
            rms_norm_eps=1e-5, attn_implementation="eager", tie_word_embeddings=False)).eval()
        hf_dino = Dinov2WithRegistersModel(Dinov2WithRegistersConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_attention_heads=2,
            image_size=28, patch_size=14, num_register_tokens=2, layerscale_value=1.0,
            hidden_act="gelu", layer_norm_eps=1e-6)).eval()
        hf_siglip = SiglipVisionModel(SiglipVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_attention_heads=2,
            image_size=28, patch_size=14, hidden_act="gelu_pytorch_tanh",
            layer_norm_eps=1e-6)).eval()
    cfg = jvlm.VLMConfig(
        llm=jllama.LlamaConfig.tiny(vocab_size=VOCAB),
        vision=(
            # HF dinov2 convention: pos over [cls, patches], registers inserted after cls
            # (HF's Dinov2 sizes its MLP by mlp_ratio 4: 128, not intermediate_size)
            jvit.ViTConfig(image_size=28, patch_size=14, hidden_size=32, num_layers=3,
                           num_heads=2, mlp_dim=128, use_cls_token=True, num_register_tokens=2,
                           no_embed_class=False, use_layerscale=True, act="gelu"),
            jvit.ViTConfig(image_size=28, patch_size=14, hidden_size=32, num_layers=3,
                           num_heads=2, mlp_dim=64, use_cls_token=False, act="gelu_tanh"),
        ),
    )
    params = {
        "vision": {"dino": dinov2_to_params(hf_dino), "siglip": siglip_to_params(hf_siglip)},
        "projector": jprojector.init_params("fused-gelu-mlp", 64, 64, jax.random.key(3)),
        "llm": jllama.params_from_hf(
            {k: v.detach().numpy() for k, v in hf_llama.state_dict().items()}, cfg.llm),
    }
    torch_proj = projector_params_to_torch(params["projector"], "fused-gelu-mlp")
    tcfg = convert.config_from_jax(cfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    serving = tvla.VLAServingConfig.for_tier(tcfg, "parity", action_dim=A_DIM, prompt_pad_len=16,
                                             codec_vocab_size=VOCAB)
    return hf_llama, hf_dino, hf_siglip, torch_proj, tparams, serving


def twin_predict_action(hf_llama, hf_dino, hf_siglip, torch_proj, pixels, ids, q01, q99, mask):
    """The reference's serving semantics on the HF modules: a full forward
    per greedy step (slow, unambiguous)."""
    with torch.no_grad():
        dino = hf_dino(pixel_values=pixels[:, :3], output_hidden_states=True).hidden_states[-2][:, 3:]
        sig = hf_siglip(pixel_values=pixels[:, 3:], output_hidden_states=True).hidden_states[-2]
        patches = torch_proj(torch.cat([dino, sig], dim=2))
        cur = ids
        for _ in range(A_DIM):
            embeds = hf_llama.get_input_embeddings()(cur)
            mm = torch.cat([embeds[:, :1], patches, embeds[:, 1:]], dim=1)
            nxt = hf_llama(inputs_embeds=mm).logits[:, -1].argmax(-1, keepdim=True)
            cur = torch.cat([cur, nxt], dim=1)
    toks = cur[:, ids.shape[1]:]
    codec = ActionCodec(vocab_size=VOCAB)
    return toks, codec.unnormalize(codec.decode(toks), q01, q99, mask)


@pytest.mark.parametrize("seed", [42, 43])
def test_predict_action_from_image_equals_the_hf_twin(twin, seed):
    hf_llama, hf_dino, hf_siglip, torch_proj, tparams, serving = twin
    r = np.random.default_rng(seed)
    image = torch.from_numpy(r.integers(0, 256, (1, 40, 40, 3), dtype=np.uint8))
    prompt = [1] + r.integers(3, VOCAB - 300, 4).tolist() + [29871 % VOCAB]
    q01 = torch.from_numpy(r.uniform(-2, 0, A_DIM).astype(np.float32))
    q99 = torch.from_numpy(r.uniform(0.5, 2, A_DIM).astype(np.float32))
    mask = torch.tensor([True] * (A_DIM - 1) + [False])
    padded = torch.zeros((1, serving.prompt_pad_len), dtype=torch.int64)
    padded[0, :len(prompt)] = torch.tensor(prompt)
    got = tvla.predict_action_from_image(tparams, serving, image, IMG_CFG, padded,
                                         torch.tensor([len(prompt)]), q01, q99, mask,
                                         device="cpu")
    pixels = apply_image_transform(image, IMG_CFG)
    want_toks, want_actions = twin_predict_action(hf_llama, hf_dino, hf_siglip, torch_proj,
                                                  pixels, torch.tensor([prompt]), q01, q99, mask)
    assert got["action_tokens"].shape == (1, A_DIM)
    torch.testing.assert_close(got["action_tokens"].long(), want_toks, atol=0, rtol=0)
    torch.testing.assert_close(got["actions"], want_actions, atol=1e-5, rtol=1e-5)
