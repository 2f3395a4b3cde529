"""Sharded serving on the CPU: the port's `make_sharded_predict`, each rank a
gloo process (`parallel.distributed.run_ranks`: ``file://`` rendezvous, one
thread a process, joined with a timeout), against the JAX package's
`make_sharded_predict` on the same mesh (its 8 virtual CPU devices) and the
port's one-process run, at the meshes and the tiny dual-tower VLA of the JAX
package's tests/test_sharded_serving.py.

Parity (float weights): greedy tokens equal to both, at all four meshes.
The probe tap `hidden_pooled` within the JAX test's own tolerance (atol
2e-4) of the one-process run. The rank workers live at module level and the
module imports no JAX at its top, so a spawned rank imports it cheaply."""

import numpy as np
import pytest
import torch

from openvla_probe_tpu_torch.models import vla as tvla
from openvla_probe_tpu_torch.ops import image as timage
from openvla_probe_tpu_torch.ops.linear import pack_int4
from openvla_probe_tpu_torch.parallel import distributed as D
from openvla_probe_tpu_torch.parallel import mesh as tmesh

MESHES = [({"dp": 4, "fsdp": 1, "tp": 2}, "tp"), ({"dp": 1, "fsdp": 2, "tp": 4}, "fsdp+tp"),
          ({"dp": 1, "fsdp": 8, "tp": 1}, "fsdp"), ({"dp": 2, "fsdp": 2, "tp": 2}, "fsdp+tp")]
RANK_TIMEOUT = 240.0
CAPTURE_ATOL = 2e-4     # tests/test_sharded_serving.py::test_sharded_capture_matches


def img_cfg(m, s=28):
    return m.ImageTransformConfig(specs=(
        m.BackboneTransformSpec((s, s), "bicubic", (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
        m.BackboneTransformSpec((s, s), "bicubic", (0.5, 0.5, 0.5), (0.5, 0.5, 0.5))))


def inputs(B=4):
    """The JAX test's batch: 40 x 40 images, prompts of 7 tokens padded to 12."""
    r = np.random.default_rng(0)
    image = r.integers(0, 256, size=(B, 40, 40, 3), dtype=np.uint8)
    ids = np.zeros((B, 12), np.int32)
    ids[:, 0] = 1
    ids[:, 1:7] = r.integers(3, 500, (B, 6))
    return (image, ids, np.full((B,), 7, np.int32), -np.ones(5, np.float32),
            np.ones(5, np.float32), np.array([True] * 4 + [False]))


def to_port(tree):
    """A JAX pytree (numpy leaves) -> torch tensors on the CPU, int4 codes
    packed two a byte as the port stores them."""
    if isinstance(tree, dict):
        return {k: to_port(v) for k, v in tree.items()}
    if tree is None:
        return None
    a = np.asarray(tree)
    if a.dtype.name == "int4":
        return pack_int4(torch.from_numpy(a.astype(np.int8)))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def jax_setup(llm_kw=None):
    """(JAX serving config, JAX params) of the JAX test's tiny VLA."""
    import jax

    from openvla_probe_tpu.models import llama, vit, vla, vlm

    cfg = vlm.VLMConfig(llm=llama.LlamaConfig.tiny(**(llm_kw or {})),
                        vision=(vit.ViTConfig.tiny(num_register_tokens=4, no_embed_class=True),
                                vit.ViTConfig.tiny()),
                        vision_names=("dino", "siglip"), arch_specifier="no-align+fused-gelu-mlp")
    serving = vla.VLAServingConfig(vlm=cfg, action_dim=5, prompt_pad_len=12,
                                   codec_vocab_size=cfg.llm.vocab_size)
    return serving, vlm.init_params(cfg, jax.random.key(0))


def port_config(jserving, int8_route: bool = False):
    """The port's config of a JAX serving config; `int8_route`: the JAX
    package's default route of quantized leaves (no kernel gate: `_w8a8_dot`,
    the grouped / requant int4 dots), i.e. the port's "w8a8" route without
    the fused norm."""
    from openvla_probe_tpu_torch import convert

    cfg = convert.config_from_jax(jserving)
    if int8_route:
        cfg = tvla.dataclasses.replace(cfg, vlm=tvla.turbo_routes(cfg.vlm, fused_rmsq=False))
    return cfg


def jax_call(params, serving, args, mesh_axes=None, strategy="tp", n=8, **kw):
    """The JAX package's result (numpy), sharded on `mesh_axes` or on one device."""
    import functools

    import jax
    import jax.numpy as jnp

    from openvla_probe_tpu.models import vla
    from openvla_probe_tpu.ops import image as jimage
    from openvla_probe_tpu.parallel.mesh import make_mesh

    if mesh_axes is None:
        fn = jax.jit(functools.partial(vla.predict_action_from_image, cfg=serving,
                                       image_cfg=img_cfg(jimage), **kw))
        names = ("image_u8", "input_ids", "prompt_len", "q01", "q99", "action_mask")
        out = fn(params, **{k: jnp.asarray(v) for k, v in zip(names, args)})
    else:
        mesh = make_mesh(dict(mesh_axes), jax.devices()[:n])
        call, sharded = vla.make_sharded_predict(params, serving, mesh, image_cfg=img_cfg(jimage),
                                                 strategy=strategy, **kw)
        out = call(sharded, *args)
    return jax.tree.map(np.asarray, out)


def port_call(params, serving, args, **kw):
    out = tvla.predict_action_from_image(params, serving, args[0], img_cfg(timage), *args[1:],
                                         device="cpu", **kw)
    return {k: v.numpy() for k, v in out.items()}


def rank_predict(rank, world, params, serving, args, mesh_axes, strategy, capture=False,
                 bank=None, sel=None):
    """One rank of the port's sharded call: this rank's tree and call, the
    whole batch in, the whole batch's outputs back."""
    mesh = tmesh.make_mesh(dict(mesh_axes))
    if bank is None:
        call, local = tvla.make_sharded_predict(params, serving, mesh, image_cfg=img_cfg(timage),
                                                strategy=strategy, collect_hidden_states=capture,
                                                device="cpu")
        out = call(local, *args)
    else:
        call, local, lbank = tvla.make_sharded_multilora_predict(
            params, bank, serving, mesh, image_cfg=img_cfg(timage), strategy=strategy,
            device="cpu")
        out = call(local, lbank, sel, *args)
    return {k: v.numpy() for k, v in out.items()}


def sharded(params, serving, args, mesh_axes, strategy="tp", capture=False, bank=None, sel=None):
    """Every rank's result (rank 0's returned), all ranks equal."""
    n = int(np.prod(list(mesh_axes.values())))
    res = D.run_ranks(rank_predict, n, (params, serving, args, mesh_axes, strategy, capture, bank,
                                        sel), timeout=RANK_TIMEOUT, device="cpu")
    for r in res[1:]:
        for k in res[0]:
            np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)
    return res[0]


@pytest.fixture(scope="module")
def parity():
    jserving, jparams = jax_setup()
    params = to_port(jax_np(jparams))
    serving = port_config(jserving)
    args = inputs()
    return jserving, jparams, serving, params, args, jax_call(jparams, jserving, args)


def jax_np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("mesh_axes,strategy", MESHES)
def test_sharded_tokens_match_jax_and_one_process(parity, mesh_axes, strategy):
    jserving, jparams, serving, params, args, want = parity
    one = port_call(params, serving, args)
    np.testing.assert_array_equal(one["action_tokens"], want["action_tokens"])
    got = sharded(params, serving, args, mesh_axes, strategy)
    np.testing.assert_array_equal(got["action_tokens"], one["action_tokens"])
    jsh = jax_call(jparams, jserving, args, mesh_axes, strategy)
    np.testing.assert_array_equal(got["action_tokens"], jsh["action_tokens"])
    np.testing.assert_allclose(got["actions"], one["actions"], atol=1e-6)


def test_sharded_capture_matches(parity):
    """collect_hidden_states at dp = 4 x tp = 2: hidden_pooled within the JAX
    test's tolerance of the one-process tap, and of the JAX sharded tap."""
    jserving, jparams, serving, params, args, _ = parity
    want = port_call(params, serving, args, collect_hidden_states=True)
    got = sharded(params, serving, args, {"dp": 4, "fsdp": 1, "tp": 2}, "tp", capture=True)
    assert got["hidden_pooled"].shape == want["hidden_pooled"].shape
    np.testing.assert_allclose(got["hidden_pooled"], want["hidden_pooled"], atol=CAPTURE_ATOL)
    jsh = jax_call(jparams, jserving, args, {"dp": 4, "fsdp": 1, "tp": 2}, "tp",
                   collect_hidden_states=True)
    np.testing.assert_allclose(got["hidden_pooled"], jsh["hidden_pooled"], atol=CAPTURE_ATOL)
    np.testing.assert_array_equal(got["action_tokens"], want["action_tokens"])


def test_sharded_dp_divisibility_error(parity):
    """A batch dp does not divide raises, as the JAX call does."""
    _, _, serving, params, _, _ = parity
    mesh = tmesh.Mesh({"dp": 4, "tp": 2}, rank=0)
    call, local = tvla.make_sharded_predict(params, serving, mesh, image_cfg=img_cfg(timage),
                                            device="cpu")
    with pytest.raises(ValueError, match="divisible by 4"):
        call(local, *inputs(B=6))
