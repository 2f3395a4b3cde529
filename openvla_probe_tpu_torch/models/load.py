"""Public model loaders: available_models / load / load_vla (counterpart of
``openvla_probe_tpu/models/load.py``).

The JAX package's discovery order and errors (reference
prismatic/models/load.py:52-226):

  * local HF-layout safetensors dirs (released OpenVLA models, exports),
  * local reference-NATIVE run dirs (`config.json` +
    `checkpoints/latest-checkpoint.pt` [+ `dataset_statistics.json`]) and
    direct `.pt` checkpoint paths (the reference `load_vla` calling
    convention),
  * HF-Hub ids: registry ids against TRI-ML/prismatic-vlms
    (`{model_id}/config.json` + `{model_id}/checkpoints/latest-checkpoint.pt`),
    VLA run ids against openvla/openvla-dev
    (`{model_type}/{id}/{config.json,dataset_statistics.json,checkpoints/step-*.pt}`
    with `step_to_load` selection), and `org/name` ids as full HF repos
    (an HF-layout snapshot, e.g. openvla/openvla-7b).

Three deliberate differences from the JAX package (ROADMAP Queue 3):

  * **Hub ids resolve from the local hub cache only**, with or without
    ``OVLA_HUB_OFFLINE=1``: ``<cache>/models--{org}--{name}/refs/main`` names
    the snapshot, ``snapshots/<sha>/<file>`` holds the file, and a file that
    is not there raises and names it. There is no download.
  * **The tokenizer is the checkpoint's ``tokenizer.json``, read by the
    port's own reader** (`models.tokenization`, no ``tokenizers`` or
    ``transformers``), unless the caller passes ``tokenizer=`` (any object
    with ``.encode(str) -> List[int]`` that adds BOS), which wins. Without
    either, `load` returns the bundle with ``tokenizer: None`` and a warning,
    as the JAX package does, and `load_vla` raises naming both before it
    reads any weight. A file the reader does not implement, or a directory
    with only ``tokenizer.model``, raises (the JAX package falls back to
    ``transformers`` there).
  * **Quantization runs on the card, one leaf at a time**: each bf16 leaf is
    read, moved to `device` one layer at a time and quantized there by
    ``ops.linear.quantize_params``' rule (codes bit-equal to quantize_params
    of the whole tree); the bf16 trunk never exists whole on either side.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import torch

from ..device import DeviceLike, resolve_device
from ..overwatch import initialize_overwatch
from ..vla.norm_stats import load_dataset_statistics
from . import catalog, vla, vlm
from .tokenization import load_tokenizer

overwatch = initialize_overwatch(__name__)

HF_HUB_REPO = "TRI-ML/prismatic-vlms"       # base-VLM run dirs
VLA_HF_HUB_REPO = "openvla/openvla-dev"     # VLA run dirs
_NO_TOKENIZER = ("load_vla needs a tokenizer: pass tokenizer= (an object whose .encode(str) "
                 "returns the ids with BOS), or put the checkpoint's tokenizer.json in {}")


def _hub_offline() -> bool:
    return os.environ.get("OVLA_HUB_OFFLINE", "0") == "1"


def hub_cache_dir(cache_dir=None) -> Path:
    """The hub cache: `cache_dir`, else $HF_HUB_CACHE, else $HF_HOME/hub, else
    ~/.cache/huggingface/hub (huggingface_hub's own order)."""
    if cache_dir is not None:
        return Path(cache_dir)
    if os.environ.get("HF_HUB_CACHE"):
        return Path(os.environ["HF_HUB_CACHE"])
    home = os.environ.get("HF_HOME") or os.path.join(os.path.expanduser("~"), ".cache",
                                                     "huggingface")
    return Path(home) / "hub"


def _hub_snapshot(repo_id: str, cache_dir=None, hf_token=None) -> Path:
    """The cached snapshot of `repo_id` that refs/main names (`hf_token` is
    not needed: nothing is fetched)."""
    repo = hub_cache_dir(cache_dir) / f"models--{repo_id.replace('/', '--')}"
    ref = repo / "refs" / "main"
    if not ref.is_file():
        raise FileNotFoundError(
            f"`{repo_id}` is not in the local hub cache (no {ref}); the port reads hub "
            "repos from the cache only and downloads nothing")
    snap = repo / "snapshots" / ref.read_text().strip()
    if not snap.is_dir():
        raise FileNotFoundError(f"`{repo_id}`: refs/main names {snap}, which is not in the "
                                "local hub cache")
    return snap


def _hub_download(repo_id: str, filename: str, cache_dir=None, hf_token=None) -> Path:
    """`filename` of the cached snapshot of `repo_id`."""
    path = _hub_snapshot(repo_id, cache_dir, hf_token) / filename
    if not path.is_file():
        raise FileNotFoundError(
            f"`{filename}` of `{repo_id}` is not in the local hub cache ({path}); the port "
            "reads hub repos from the cache only and downloads nothing")
    return path


def _is_native_run_dir(path: Path) -> bool:
    ckpts = path / "checkpoints"
    return ckpts.is_dir() and any(ckpts.glob("*.pt"))


def _latest_native_ckpt(path: Path) -> Path:
    latest = path / "checkpoints" / "latest-checkpoint.pt"
    if latest.exists():
        return latest
    cands = sorted((path / "checkpoints").glob("*.pt"))
    if not cands:
        raise FileNotFoundError(f"No .pt checkpoint under {path / 'checkpoints'}")
    return cands[-1]


def available_models() -> List[str]:
    return list(catalog.MODEL_REGISTRY.keys())


def available_model_names() -> List[str]:
    return [m["names"][0] for m in catalog.MODEL_REGISTRY.values()]


def get_model_description(model_id_or_name: str) -> str:
    meta = catalog.GLOBAL_REGISTRY.get(model_id_or_name)
    if meta is None:
        raise ValueError(f"Unknown model `{model_id_or_name}`; have {available_models()}")
    desc = meta["description"]
    if isinstance(desc, dict):
        return json.dumps(desc, indent=2)
    return str(desc)


def load(
    model_path: Union[str, Path],
    dtype: torch.dtype = torch.bfloat16,
    cache_dir: Optional[Union[str, Path]] = None,
    hf_token: Optional[str] = None,
    tokenizer: Any = None,
    device: DeviceLike = "cuda",
    llm_bits=None,
) -> Dict[str, Any]:
    """Load a base Prismatic VLM from local disk or the local hub cache onto
    `device`.

    Mirrors the reference `load()` (prismatic/models/load.py:52-118): a local
    dir loads directly (HF-layout or native run dir); a registry id reads
    `{model_id}/config.json` + `{model_id}/checkpoints/latest-checkpoint.pt`
    of TRI-ML/prismatic-vlms; an `org/name` id reads that repo's snapshot.
    `llm_bits` quantizes the LLM leaves on the way (`load_vla`).

    Returns {params, cfg, image_cfg, prompt_builder, norm_stats, tokenizer}:
    the caller's `tokenizer`, else the checkpoint's tokenizer.json, else None
    with a warning."""
    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev, llm_bits=llm_bits)
    path = Path(model_path)
    if path.is_dir():
        if _is_native_run_dir(path):
            overwatch.info(f"Loading native run dir `{path}`")
            bundle = catalog.load_prismatic_checkpoint(
                path / "config.json", _latest_native_ckpt(path),
                path / "dataset_statistics.json", **kw)
        else:
            bundle = catalog.load_openvla_hf_checkpoint(path, **kw)
        bundle["tokenizer"] = _tokenizer_for(path, tokenizer)
        return bundle

    model_id = str(model_path)
    if model_id in catalog.GLOBAL_REGISTRY or model_id in catalog.MODEL_REGISTRY:
        meta = catalog.GLOBAL_REGISTRY.get(model_id) or catalog.MODEL_REGISTRY[model_id]
        if meta.get("hf_repo"):
            # released policies (openvla-7b etc.) ship as standalone
            # HF-layout repos, not TRI-ML run dirs
            snap = _hub_snapshot(meta["hf_repo"], cache_dir, hf_token)
            bundle = catalog.load_openvla_hf_checkpoint(snap, **kw)
            bundle["tokenizer"] = _tokenizer_for(snap, tokenizer)
            return bundle
        hub_id = meta.get("model_id", model_id)
        overwatch.info(f"Reading `{hub_id}` of {HF_HUB_REPO} from the local hub cache")
        config_json = _hub_download(HF_HUB_REPO, f"{hub_id}/config.json", cache_dir, hf_token)
        checkpoint_pt = _hub_download(
            HF_HUB_REPO, f"{hub_id}/checkpoints/latest-checkpoint.pt", cache_dir, hf_token)
        bundle = catalog.load_prismatic_checkpoint(config_json, checkpoint_pt, **kw)
        bundle["tokenizer"] = _tokenizer_for(config_json.parent, tokenizer)
        return bundle
    if "/" in model_id:
        snap = _hub_snapshot(model_id, cache_dir, hf_token)
        bundle = catalog.load_openvla_hf_checkpoint(snap, **kw)
        bundle["tokenizer"] = _tokenizer_for(snap, tokenizer)
        return bundle
    raise ValueError(
        f"`{model_id}` is neither a local checkpoint dir, a registry id "
        f"(see available_models()), nor an org/name HF repo id")


def load_vla(
    checkpoint_path: Union[str, Path],
    dtype: torch.dtype = torch.bfloat16,
    prompt_pad_len: int = 48,
    quantize_int8: bool = False,
    quantize_bits: Union[int, str] = 8,
    cache_dir: Optional[Union[str, Path]] = None,
    hf_token: Optional[str] = None,
    step_to_load: Optional[int] = None,
    model_type: str = "pretrained",
    tokenizer: Any = None,
    device: DeviceLike = "cuda",
) -> vla.OpenVLA:
    """Load an OpenVLA policy ready to serve on `device`, from disk or the
    local hub cache, with the caller's `tokenizer` or the checkpoint's
    tokenizer.json (read before any weight: with neither, it raises).

    Mirrors the reference `load_vla()` discovery (prismatic/models/load.py:
    122-226): a direct `.pt` path under `<run>/checkpoints/`, an HF-layout or
    native run dir, an openvla/openvla-dev run id (`{model_type}/{id}` with
    `step_to_load` checkpoint selection), or an `org/name` HF repo
    (e.g. openvla/openvla-7b). `quantize_int8` switches the Llama trunk and
    lm_head to the turbo tier's weights: per-channel int8, grouped int4 with
    `quantize_bits=4`, int8 and int4 copies with `quantize_bits="mix"`, or
    two 4-bit planes with `quantize_bits="nibble"`, quantized on `device`
    one layer of one leaf at a time (the towers and projector stay bf16, as
    in the JAX package); bf16 stays the bit-parity tier. The serving config
    is the JAX package's (`tier="turbo"` over the checkpoint's numerics) with
    the turbo tier's kernel routes (`vla.turbo_routes`)."""
    if tokenizer is None:
        try:
            tok_dir = _tokenizer_dir(checkpoint_path, model_type, cache_dir, hf_token)
        except FileNotFoundError:    # nowhere to read a file from
            tok_dir = None
        tokenizer = _tokenizer_for(tok_dir, None) if tok_dir is not None else None
        if tokenizer is None:
            raise ValueError(_NO_TOKENIZER.format(tok_dir or checkpoint_path))
    if quantize_bits != 8 and not quantize_int8:
        # conflicting knobs RAISE (the with_env_overrides convention):
        # silently serving bf16 parity after the caller asked for an int4/mix
        # trunk would mislabel every downstream measurement
        raise ValueError(
            f"quantize_bits={quantize_bits!r} requires quantize_int8=True "
            "(the quantize switch); without it the model serves bf16 parity")
    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev, llm_bits=quantize_bits if quantize_int8 else None)
    path = Path(checkpoint_path)
    if path.is_file():
        # reference calling convention: .../<RUN_ID>/checkpoints/<CKPT>.pt
        if path.suffix != ".pt" or path.parent.name != "checkpoints":
            raise ValueError(f"Expected .../<run>/checkpoints/<ckpt>.pt, got {path}")
        run_dir = path.parents[1]
        bundle = catalog.load_prismatic_checkpoint(
            run_dir / "config.json", path, run_dir / "dataset_statistics.json", **kw)
        path = run_dir
    elif (not path.is_dir()
          and (str(checkpoint_path) in catalog.GLOBAL_REGISTRY
               or str(checkpoint_path) in catalog.MODEL_REGISTRY)):
        # registry ids route through load() (which honors hf_repo for
        # released standalone policies like openvla-7b)
        bundle = load(checkpoint_path, cache_dir=cache_dir, hf_token=hf_token,
                      tokenizer=tokenizer, **kw)
    elif not path.is_dir() and "/" not in str(checkpoint_path):
        # openvla-dev run id: {model_type}/{id}/... with step discovery
        bundle, path = _load_vla_from_hub(str(checkpoint_path), model_type, step_to_load,
                                          cache_dir, hf_token, **kw)
    else:
        bundle = load(path, cache_dir=cache_dir, hf_token=hf_token, tokenizer=tokenizer, **kw)
    norm_stats = bundle.get("norm_stats") or {}
    sidecar = Path(path) / "dataset_statistics.json"
    if sidecar.exists():
        norm_stats = load_dataset_statistics(sidecar)
    if not norm_stats:
        overwatch.warning("Checkpoint carries no norm_stats; predict_action will need explicit stats")
    vlm_cfg = bundle["cfg"]
    serving = vla.VLAServingConfig(
        vlm=vla.turbo_routes(vlm_cfg) if quantize_int8 else vlm_cfg,
        prompt_pad_len=prompt_pad_len,
        codec_vocab_size=_codec_vocab_size(path, vlm_cfg),
        # int8 weights already forgo bit-parity, so the config says so: this
        # is what unlocks turbo-tier features (speculative drafts)
        tier="turbo" if quantize_int8 else "parity",
    )
    return vla.OpenVLA(bundle["params"], serving, tokenizer, norm_stats, bundle["image_cfg"],
                       device=dev)


def _tokenizer_for(path: Path, tokenizer: Any = None):
    """The caller's `tokenizer`, else `path`'s tokenizer.json through the
    port's reader, else None with a warning (the JAX package's _tokenizer_for;
    a file the reader does not implement raises)."""
    if tokenizer is not None:
        return tokenizer
    path = Path(path)
    if not (path / "tokenizer.json").is_file() and not (path / "tokenizer.model").exists():
        overwatch.warning(
            f"No tokenizer files under {path}; pass/attach one explicitly before serving "
            "— predict_action needs .encode")
        return None
    return load_tokenizer(path)


def _tokenizer_dir(checkpoint_path, model_type: str, cache_dir, hf_token) -> Path:
    """The directory whose tokenizer files `load_vla(checkpoint_path)` reads:
    the run dir of a `.pt` path, a local dir, the snapshot of a released
    policy or `org/name` repo, or the directory of a hub run's config.json."""
    path = Path(checkpoint_path)
    if path.is_file():
        return path.parents[1]
    if path.is_dir():
        return path
    model_id = str(checkpoint_path)
    if model_id in catalog.GLOBAL_REGISTRY or model_id in catalog.MODEL_REGISTRY:
        meta = catalog.GLOBAL_REGISTRY.get(model_id) or catalog.MODEL_REGISTRY[model_id]
        if meta.get("hf_repo"):
            return _hub_snapshot(meta["hf_repo"], cache_dir, hf_token)
        hub_id = meta.get("model_id", model_id)
        return _hub_download(HF_HUB_REPO, f"{hub_id}/config.json", cache_dir, hf_token).parent
    if "/" not in model_id:
        return _hub_download(VLA_HF_HUB_REPO, f"{model_type}/{model_id}/config.json", cache_dir,
                             hf_token).parent
    return _hub_snapshot(model_id, cache_dir, hf_token)


def _load_vla_from_hub(
    run_id: str,
    model_type: str,
    step_to_load: Optional[int],
    cache_dir,
    hf_token,
    **kw,
):
    """openvla/openvla-dev discovery: `{model_type}/{run_id}/{config.json,
    dataset_statistics.json, checkpoints/step-*.pt}` with step selection
    (reference prismatic/models/load.py:146-170), over the cached snapshot."""
    relpath = f"{model_type}/{run_id}"
    config_json = _hub_download(VLA_HF_HUB_REPO, f"{relpath}/config.json", cache_dir, hf_token)
    stats_json = _hub_download(VLA_HF_HUB_REPO, f"{relpath}/dataset_statistics.json",
                               cache_dir, hf_token)
    step_tag = f"{step_to_load:06d}" if step_to_load is not None else ""
    # the snapshot is on local disk: discover checkpoints next to config
    cands = sorted((config_json.parent / "checkpoints").glob(f"step-{step_tag}*.pt"))
    cands = [c.name for c in cands]
    if not cands or (step_to_load is not None and len(cands) != 1):
        raise ValueError(
            f"Couldn't find a unique checkpoint for step={step_to_load} under "
            f"{relpath}/checkpoints (found {cands})")
    checkpoint_pt = _hub_download(
        VLA_HF_HUB_REPO, f"{relpath}/checkpoints/{sorted(cands)[-1]}", cache_dir, hf_token)
    bundle = catalog.load_prismatic_checkpoint(config_json, checkpoint_pt, stats_json, **kw)
    return bundle, config_json.parent


def _codec_vocab_size(path: Path, cfg: vlm.VLMConfig) -> int:
    """Effective action vocab: text vocab minus the pad_to_multiple_of round-up
    (extern/hf/modeling_prismatic.py:500-504)."""
    try:
        with open(path / "config.json") as f:
            hf_cfg = json.load(f)
        return int(hf_cfg["text_config"]["vocab_size"]) - int(hf_cfg.get("pad_to_multiple_of", 64))
    except Exception:
        return cfg.llm.vocab_size - 64 if cfg.llm.vocab_size % 64 == 0 and cfg.llm.vocab_size > 32000 else cfg.llm.vocab_size
