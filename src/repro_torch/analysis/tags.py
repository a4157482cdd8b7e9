"""Central registry of the port's constant stream parts — the single source
of truth for every static RNG derivation in ``repro_torch`` (port of
``repro.analysis.tags``).

The reference folds constant tags into JAX keys; the port draws every
stream from a fresh generator seeded by ``core.rng.derive_seed(*parts)``
(``core.rng.generator(device, *parts)``), where a part is an int (a seed, a
round index ``t``, a node or layer index) or a string.  Two streams are
disjoint exactly when their parts differ, so every *constant string* part
that reaches ``generator`` or ``derive_seed`` must be registered here —
``rng_lint`` rejects any other (rule ``rng-stream-tag``).  Dynamic parts
(``t``, a leaf ``path``, a loop's key) are not tags.

Each entry says which stream it names and how its parts are laid out.
Constants only: no imports, no torch.
"""

# ---------------------------------------------------------------------------
# A round's draws (core/rng.py ``RoundRandom``; keyed by the run's seed and
# the global round index t, so chunking and resume never change a run)
# ---------------------------------------------------------------------------

#: the round's compression plan: ``derive_seed(seed, t, "compress")``, and a
#: registry compressor's per-leaf plan ``(seed, t, "compress", path)``
COMPRESS_TAG = "compress"
#: a tree leaf's compression mask: ``(seed, t, "mask", path)``; a sharded
#: leaf's local block adds its shard offsets ``(..., path, *offsets)``
#: (compress/treelevel.py ``_shard_draw``)
MASK_TAG = "mask"
#: the h-update's oracle samples: ``(seed, t, "samples", tag)``, a client's
#: own ``(seed, t, "samples", tag, client)``
SAMPLES_TAG = "samples"
#: a host coin (PAGE's reset, the sync round): ``(seed, t, "coin", tag)``
COIN_TAG = "coin"
#: a sampled round's c-of-n cohort, numpy: ``(seed, t, "cohort")``
COHORT_TAG = "cohort"

# ---------------------------------------------------------------------------
# Inside a plan (compress/spec.py; the plan's own seed comes from the
# round's COMPRESS_TAG stream)
# ---------------------------------------------------------------------------

#: a compressor's plan draws (RandK indices, PermK shift, Bernoulli mask,
#: QDither uniforms): ``(plan_seed, "plan")``
PLAN_TAG = "plan"
#: Appendix-D partial-participation coins: ``(plan_seed, "participation")``
PARTICIPATION_TAG = "participation"

# ---------------------------------------------------------------------------
# Runs: the trainer and the server (launch/train.py, launch/serve.py) and
# the Driver's per-round data (methods/driver.py)
# ---------------------------------------------------------------------------

#: the model's parameters: ``derive_seed(args.seed, "init")``
INIT_TAG = "init"
#: the method state's seed: ``derive_seed(args.seed, "state")``
STATE_TAG = "state"
#: the held-out eval batch: ``derive_seed(args.seed, "eval")``
EVAL_TAG = "eval"
#: the data stream: ``derive_seed(args.seed, "data")`` is the run's data
#: seed, and round t's batch seed is ``derive_seed(data_seed, t, "data")``
DATA_TAG = "data"
#: the server's prompt: ``derive_seed(args.seed, "prompt")``
PROMPT_TAG = "prompt"

# ---------------------------------------------------------------------------
# Synthetic data (data/pipeline.py; each array from ``(seed, tag)``)
# ---------------------------------------------------------------------------

#: classification features, teacher and label flips
FEATURES_TAG = "features"
TEACHER_TAG = "teacher"
FLIPS_TAG = "flips"
#: the quadratic's matrix and vector
Q_TAG = "q"
B_TAG = "b"
#: the LM token stream: its repeating base, noise tokens and noise mask
BASE_TAG = "base"
NOISE_TAG = "noise"
NOISY_TAG = "noisy"
#: the VLM's image embeddings and whisper's frames (the pipeline's
#: ``modality_kw`` keys, drawn as ``(seed, key)``)
IMAGE_EMBEDS_TAG = "image_embeds"
FRAMES_TAG = "frames"

# ---------------------------------------------------------------------------
# Parameters (models/init.py ``_Draws``: ``(seed, *parts)``, one generator
# per part tuple)
# ---------------------------------------------------------------------------

#: the embedding and the untied head
EMBED_TAG = "embed"
LM_HEAD_TAG = "lm_head"
#: a block's name: ``("layer", i)``, gemma3's ``("local", g, j)`` /
#: ``("global", g)``, the VLM / whisper cross blocks ``("cross", i)``,
#: whisper's encoder ``("enc", i)``, zamba2's ``("shared_attn",)``
LAYER_TAG = "layer"
LOCAL_TAG = "local"
GLOBAL_TAG = "global"
CROSS_TAG = "cross"
ENC_TAG = "enc"
SHARED_ATTN_TAG = "shared_attn"
#: a block's attention and feed-forward: ``(*block, "attn" | "ffn")``
ATTN_TAG = "attn"
FFN_TAG = "ffn"

#: name -> value; ``rng_lint`` accepts a constant string part iff it is
#: one of these values (or a name of this registry)
REGISTERED_TAGS = {name: value for name, value in dict(globals()).items()
                   if name.endswith("_TAG")}

#: Inverse map for findings messages / audits.
TAG_NAMES = {v: k for k, v in REGISTERED_TAGS.items()}
