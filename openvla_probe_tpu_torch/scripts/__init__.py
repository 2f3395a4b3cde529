"""The port's command line (counterparts of the JAX package's ``scripts/``).

Each script runs as ``python -m openvla_probe_tpu_torch.scripts.<name>``
with its JAX counterpart's config fields, defaults and ``--field value`` flags
(``conf.registry.parse_config``); ``--help`` lists them. The scripts that run
a model add one field, ``device``: they run on the card unless ``--device
cpu`` is given. The two in ``ON_HOST`` never touch the card and have none.
The scripts import neither JAX, PIL, ``tokenizers`` nor ``transformers``:
images go through ``utils.image_io.read_image`` and the tokenizer is the
checkpoint's ``tokenizer.json`` read by ``models.tokenization``.
"""

# the scripts that run on the host only (numpy analysis, a file export): no `device` field
ON_HOST = ("analyze_probes", "convert_weights_to_hf")
