"""Command-line interface of the port: ``train``, ``parse``, ``ingest``,
``build-ivf``, ``serve``, ``chat`` and ``convert-ckpt``.

Counterpart of ``vietnamese_qa_system_tpu/cli/main.py:26-1116`` (all but
``bench``)::

    python -m vietnamese_qa_system_tpu_torch.cli parse --parser alpaca \\
        --input examples/sample_instruct.jsonl --output-dir parsed
    python -m vietnamese_qa_system_tpu_torch.cli train --model-size tiny \\
        --use-lora --train-files parsed/AlpacaParser.jsonl --max-steps 2 \\
        --checkpoint-dir ckpt --push-to-hub org/repo --push-dry-run
    python -m vietnamese_qa_system_tpu_torch.cli convert-ckpt \\
        --checkpoint-dir ckpt --use-lora --format hf --out-dir exported

    python -m vietnamese_qa_system_tpu_torch.cli train --model-size phogpt4b \\
        --use-lora --quantize-base int8 --remat-policy proj_bf16 \\
        --train-files examples/sample_instruct.jsonl --max-steps 2
    python -m vietnamese_qa_system_tpu_torch.cli train --model-size phogpt4b \\
        --use-lora --quantize-base nf4-dq --qlora-dequant once \\
        --host-offload all --profile-steps 1 --sharded-checkpoint \\
        --checkpoint-dir ckpt --train-files examples/sample_instruct.jsonl

    python -m vietnamese_qa_system_tpu_torch.cli ingest --inputs docs.jsonl \\
        --index idx --db docs.sqlite --encoder mpnet --dtype int8_global
    python -m vietnamese_qa_system_tpu_torch.cli build-ivf --index idx --out ivf
    python -m vietnamese_qa_system_tpu_torch.cli serve --index idx \\
        --ivf-index ivf --db docs.sqlite --encoder mpnet --port 8080 \\
        --reader-size phogpt4b --reader-quantize int8c
    python -m vietnamese_qa_system_tpu_torch.cli chat --model-size phogpt4b \\
        --quantize int8c

    python -m vietnamese_qa_system_tpu_torch.cli ingest --inputs docs.jsonl \\
        --index idx --db docs.sqlite --encoder /path/to/hf-mpnet-dir --hybrid
    python -m vietnamese_qa_system_tpu_torch.cli serve --index idx \\
        --db docs.sqlite --encoder /path/to/hf-mpnet-dir --hybrid-weight 0.5 \\
        --reader-size phogpt4b --reader-params /path/to/hf-phogpt-dir \\
        --reader-quantize int8c
    python -m vietnamese_qa_system_tpu_torch.cli serve --index idx \\
        --db docs.sqlite --port 8080 --reader-size phogpt4b \\
        --reader-quantize nf4 --continuous-slots 8 \\
        --adapter vi=ckpt_vi/adapter.npz --adapter law=ckpt_law/adapter.npz

    python -m vietnamese_qa_system_tpu_torch.cli serve --index idx \\
        --db docs.sqlite --port 8080 --reader-size mt5small \\
        --reader-params /path/to/hf-mt5-dir --reader-quantize int8c \\
        --continuous-slots 8 --gen-total 256
    python -m vietnamese_qa_system_tpu_torch.cli chat --arch seq2seq \\
        --init-params /path/to/hf-mbart-dir
    python -m vietnamese_qa_system_tpu_torch.cli train --arch seq2seq \\
        --model-size mt5small --use-lora --quantize-base int8 \\
        --train-files examples/sample_instruct.jsonl --max-steps 2

Each takes ``--device`` (default ``cuda``; a missing GPU raises).
``--encoder`` takes a preset or a local Hugging Face BERT / MPNet
directory (the model's configuration then comes from its config.json).
``serve --reader-params``, ``chat --init-params`` and ``train
--init-params`` load a local Hugging Face causal-LM or seq2seq (T5 / mT5
/ LongT5, mBART) directory (streamed onto the device a layer at a time,
quantized as each layer is complete), a checkpoint directory
(``step_N/state.npz`` of either package's trainer) or a flat ``.npz``;
the preset's configuration is the model's, and weights that do not fit
it raise (a seq2seq directory of another family than the preset's brings
its own configuration).  Seq2seq readers: ``serve --reader-size
tiny-s2s|mt5small``, ``chat --arch seq2seq --model-size
tiny|mt5small|seq2seq-small`` and ``train --arch seq2seq``; they encode
right-padded inputs, answer with new tokens only and decode without
speculation.  Without them the reader answers, and ``train``
starts, with random weights drawn from ``--seed`` on the device.  ``ingest
--hybrid`` keeps a BM25 term index (``bm25.json``) beside the store, and
``serve`` fuses it with the dense scores when ``--hybrid-weight`` is below
1.  ``serve --port --reader-size ... --continuous-slots N`` adds ``POST
/generate``: raw completions through the continuous-batching engine
(``--gen-total``, ``--gen-chunk-steps``, ``--prefix-cache-mb``,
``--gen-speculative``, ``--draft-tokens``, ``--draft-ngram``, ``--kv-quant``,
``--prefill-chunk``; ``--max-new-tokens`` is the default budget of /qa and
/generate alike).  ``serve`` decodes /qa with prompt-lookup speculation by
default (``--speculative ngram``; ``draft`` takes a draft model of
``--reader-draft-size``, weights from ``--reader-draft-params`` else random
from the seed), and ``chat`` takes ``--num-beams``, ``--speculative`` and
``--draft-*`` with the JAX CLI's defaults.  ``train --do-eval
--do-generative-eval`` decodes the eval prompts by the generation group
(``--max-new-tokens`` ... ``--num-beams``, ``--speculative``) and logs the
predictions.  ``train --quantize-base int8|nf4|nf4-dq`` trains LoRA over a
quantized base, dequantized where ``--qlora-dequant`` says; ``--host-offload``
keeps the optimizer state and / or the parameters in host memory between
steps; ``--profile-steps N`` writes a torch.profiler trace of the first N
steps to ``--profile-dir``; ``--sharded-checkpoint`` writes the per-host
checkpoint layout.  ``serve --reader-quantize`` and ``chat --quantize``
take int8, int8c, nf4 or nf4-dq; ``serve --adapter NAME=PATH``
(repeatable; ``--adapter-r``, ``--adapter-alpha``, ``--adapter-targets``)
serves LoRA adapters (``adapter.npz`` of either package's ``train
--use-lora --checkpoint-dir``) over the shared reader on ``/generate``.
``train --strategy dp|zero2|fsdp|tp|fsdp_tp --mesh JSON`` trains over a
mesh (``train/mesh.py``): with ``--device cpu`` its positions repeat the
host, with ``cuda`` they are the visible GPUs (fewer than the axes need
raise); ``--do-eval`` then splits the eval batches over the data axis.
Every strategy takes ``--arch seq2seq`` (tp and fsdp_tp split T5 / mT5,
mBART and the native stack over the model axis), a float, int8, nf4 or
nf4-dq base, and ``--host-offload``.
``ingest --shards`` / ``build-ivf --shards`` shard the store and the IVF
index, and ``serve --reader-strategy tp|fsdp_tp`` splits the reader over
the GPUs.  ``parse`` runs a dataset parser of the offline ETL (``etl/``;
``--translate`` goes through the identity translator, as in the JAX
CLI).  ``convert-ckpt`` restores a ``train`` checkpoint, merges its LoRA
adapter (dequantizing a ``--quantize-base`` base) and writes an HF
directory (``--format hf``: the causal families, or T5 with the
tokenizer's special-token ids) or ``params.npz`` with ``config.json``
(``--format npz``).  ``train --push-to-hub REPO`` exports the merged model
to ``<log-dir>/export`` and pushes it, or records ``push_manifest.json``
(``--push-dry-run``, no ``HF_TOKEN``, or a failed upload); ``--report-to
wandb`` falls back to jsonl where wandb does not start.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
from typing import Optional

from ..utils.logging import dist_print

# presets of the retrieval encoders (cli/main.py:547-551)
ENCODERS = ("tiny", "minilm", "mpnet")
# presets of the causal readers (cli/main.py:171-182, :710-720)
READERS = ("tiny", "gpt125m", "gptneo125m", "pythia410m", "llama1b", "qwen2-05b", "bloom560m", "phogpt4b")
# presets of the seq2seq models: serve's readers (cli/main.py:718-719) and train / chat's sizes
S2S_READERS = ("tiny-s2s", "mt5small")
S2S_SIZES = ("mt5small", "seq2seq-small")
SEQ2SEQ_TYPES = ("t5", "mt5", "longt5", "mbart")
# presets of the draft models of --speculative draft (cli/main.py:1259-1262)
DRAFTS = ("tiny", "gpt125m", "gptneo125m", "pythia410m", "qwen2-05b", "bloom560m")


def _causal_preset(size: str, arch: str = "causal"):
    """The ModelConfig of a preset name (``tiny`` of ``arch``)."""
    from ..models import config as mcfg

    return {
        "tiny": lambda: mcfg.tiny_test(arch), "gpt125m": mcfg.gpt_125m_class, "gptneo125m": mcfg.gpt_neo_125m,
        "pythia410m": mcfg.pythia_410m_class, "llama1b": mcfg.llama_1b_class, "qwen2-05b": mcfg.qwen2_05b_class,
        "bloom560m": mcfg.bloom_560m_class, "phogpt4b": mcfg.phogpt_4b_class,
        "tiny-s2s": lambda: mcfg.tiny_test("seq2seq"), "mt5small": mcfg.mt5_small_class,
        "seq2seq-small": mcfg.seq2seq_native_small,
    }[size]()


def _encoder(spec: str, seed: int, device):
    """An encoder by preset name (random weights from ``seed``) or from a
    local HF BERT / MPNet directory, whose config.json gives the model's
    configuration (cli/main.py:535-553)."""
    from ..core.device import make_generator
    from ..models import encoder_from_hf, init_encoder, minilm_class, mpnet_class, tiny_test

    if os.path.isdir(spec):
        return encoder_from_hf(spec, device=device)
    presets = {"tiny": lambda: tiny_test("encoder"), "minilm": minilm_class, "mpnet": mpnet_class}
    if spec not in presets:
        raise SystemExit(f"unknown encoder {spec!r}: use one of {', '.join(ENCODERS)}")
    return init_encoder(presets[spec](), make_generator(seed), device=device)


def load_converted_params(path: str, cfg, device, quantize: Optional[str] = None):
    """The model of configuration ``cfg`` (a :class:`CausalLM` or an
    encoder-decoder) from a local HF directory (config.json; a causal one
    dispatched as ``load_causal_auto`` does, a T5 / mT5 / LongT5 or mBART
    one as ``load_seq2seq_auto`` does; streamed onto ``device`` and
    quantized layer by layer), a checkpoint directory (``step_N/state.npz``
    of either package's trainer: its "params" subtree, with a trained LoRA
    adapter merged into it) or a flat ``.npz`` of the parameter tree
    (cli/main.py:472-511).  Weights that do not fill ``cfg``'s model raise;
    a seq2seq directory of another family than ``cfg``'s loads with the
    file's configuration."""
    import numpy as np

    from ..models import causal_from_hf, model_from_leaves, quantize_dense_tree, seq2seq_from_hf
    from ..train.checkpoint import CheckpointManager

    if os.path.isdir(path) and os.path.exists(os.path.join(path, "config.json")):
        with open(os.path.join(path, "config.json")) as f:
            model_type = json.load(f).get("model_type")
        if model_type in SEQ2SEQ_TYPES:
            family = "bart" if model_type == "mbart" else "t5"
            if cfg.arch != "seq2seq" or cfg.seq2seq_family != family:
                dist_print(f"{path}: a {model_type} directory, loaded with its own configuration", flush=True)
                cfg = None
            return seq2seq_from_hf(path, cfg, device=device, quantize=quantize)
        return causal_from_hf(path, cfg, device=device, quantize=quantize)
    if not os.path.isdir(path):
        npz = path if path.endswith(".npz") else path + ".npz"
        with np.load(npz) as data:
            arrays = [data[f"leaf_{i}"] for i in range(len(data.files))]
        model = model_from_leaves(arrays, cfg, device=device)
    else:
        step = CheckpointManager(path).latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
        model = _trainer_params(os.path.join(path, f"step_{step}"), cfg, device)
    if quantize:
        quantize_dense_tree(model, quantize)
    return model


def _trainer_params(step_dir: str, cfg, device):
    """The model of a trainer checkpoint: its state {"adapter",
    "opt_state", "params", "step"} flattens in sorted key order, so the
    parameters are the leaves before the step and a LoRA adapter's are the
    first.  The LoRA configuration (r, alpha, targets) is read from the
    TrainConfig that both packages' trainers write into meta.json, and the
    adapter is merged into the weights (W + alpha / r * A @ B)."""
    import ast
    import re

    import numpy as np
    import torch

    from ..models import LoraConfig, clear_lora, init_lora, merge_lora, model_from_leaves
    from ..models.params import _leaf_names
    from ..utils.tree import tree_leaves, tree_unflatten

    npz = os.path.join(step_dir, "state.npz")
    with open(os.path.join(step_dir, "meta.json")) as f:
        config = json.load(f).get("config", "")
    base = re.search(r"quantize_base=('[^']*'|None)", config)
    if base and base.group(1) != "None":
        raise ValueError(f"{npz}: a checkpoint of a quantized base (quantize_base={base.group(1)}) holds quantized "
                         "base weights, which do not load as a model; train on a float base to serve the result, or "
                         "serve its adapter.npz with serve --adapter")
    lora = None
    if "lora=LoraConfig(" in config:
        m = re.search(r"lora=LoraConfig\(r=(\d+), alpha=([^,]+), targets=(\([^)]*\)|\[[^\]]*\])\)", config)
        if m is None:
            raise ValueError(f"{step_dir}/meta.json: cannot read the LoRA configuration of {config!r}")
        lora = LoraConfig(r=int(m.group(1)), alpha=ast.literal_eval(m.group(2)),
                          targets=tuple(ast.literal_eval(m.group(3))))
    with np.load(npz) as data:
        arrays = [data[f"leaf_{i}"] for i in range(len(data.files))]
    n, model = len(arrays), None
    for count in (len(_leaf_names(cfg, False)), len(_leaf_names(cfg, True))):
        if count < n and np.asarray(arrays[-1]).ndim == 0:
            try:
                model = model_from_leaves(arrays[n - 1 - count: n - 1], cfg, device=device)
                break
            except ValueError:
                continue
    if model is None:
        raise ValueError(f"{npz}: its {n} leaves hold no trainer state of this model's parameters")
    if lora is not None:
        like = init_lora(torch.Generator().manual_seed(0), model, lora)
        leaves = []
        for arr, t in zip(arrays, tree_leaves(like)):
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{npz}: an adapter leaf of shape {arr.shape} where the LoRA adapter of {lora} "
                                 f"has {tuple(t.shape)}")
            leaves.append(torch.as_tensor(np.asarray(arr, np.float32), device=model.tok_embed.device))
        merge_lora(model, tree_unflatten(like, leaves), lora)
        for mod in model.modules():
            if getattr(mod, "w_merged", None) is not None:
                mod.w = torch.nn.Parameter(mod.w_merged, requires_grad=False)
        clear_lora(model)
        dist_print(f"merged the checkpoint's LoRA adapter (r={lora.r}, alpha={lora.alpha}) into its weights",
                   flush=True)
    return model


def _reader(size: str, tok, seed: int, device, quantize: Optional[str], params: Optional[str] = None,
            arch: str = "causal"):
    """A reader of preset ``size`` (``tiny`` of ``arch``; a causal LM or an
    encoder-decoder): loaded from ``params`` (:func:`load_converted_params`),
    else with random weights drawn on ``device`` from ``seed``; quantized
    layer by layer as it is made."""
    import dataclasses

    from ..core.device import make_generator
    from ..models import init_causal_lm, init_seq2seq_model

    cfg = _causal_preset(size, arch)
    if tok.vocab_size > cfg.vocab_size:
        cfg = dataclasses.replace(cfg, vocab_size=tok.vocab_size)
    if params:
        model = load_converted_params(params, cfg, device, quantize)
        dist_print(f"reader weights loaded from {params}", flush=True)
    else:
        dist_print("(no reader checkpoint: answering with RANDOM weights)", flush=True)
        init = init_seq2seq_model if cfg.arch == "seq2seq" else init_causal_lm
        model = init(cfg, make_generator(seed, device), quantize=quantize)
    if quantize:
        dist_print(f"reader decodes over a {quantize} base", flush=True)
    return model


def _draft(size: str, vocab_size: int, seed: int, device, params: Optional[str], flag: str):
    """The draft model of ``--speculative draft``: preset ``size`` widened
    to the reader's vocabulary (the one hard invariant), loaded from
    ``params`` or drawn from ``seed`` (cli/main.py:769-785, :985-1007)."""
    import dataclasses

    from ..core.device import make_generator
    from ..models import init_causal_lm

    cfg = _causal_preset(size)
    if cfg.vocab_size != vocab_size:
        cfg = dataclasses.replace(cfg, vocab_size=vocab_size)
    if params:
        return load_converted_params(params, cfg, device)
    dist_print(f"(no {flag}: drafting with RANDOM weights)", flush=True)
    return init_causal_lm(cfg, make_generator(seed, device))


def _model_config(args):
    """The model configuration of ``--model-config`` (a JSON file), else of
    the ``--model-size`` preset."""
    from ..models import config as mcfg

    if args.model_config:
        with open(args.model_config) as f:
            return mcfg.ModelConfig.from_json(f.read())
    return _causal_preset(args.model_size, args.arch)


def _train_config(args):
    """The model configuration of ``train``: a preset or a JSON file, with
    --scan-layers / --remat-policy applied (cli/main.py:158-193)."""
    import dataclasses

    cfg = _model_config(args)
    if args.scan_layers:
        if cfg.arch != "causal" or cfg.attention_layers is not None:
            raise SystemExit("--scan-layers requires a homogeneous causal model")
        cfg = dataclasses.replace(cfg, scan_layers=True)
    if args.remat_policy:
        cfg = dataclasses.replace(cfg, remat_policy=args.remat_policy)
    return cfg


def _file_specs(files, schemas, fractions):
    from ..data import DataFileSpec

    schemas = schemas or ["instruct"] * len(files)
    fractions = fractions or [1.0] * len(files)
    fractions = [f / 100.0 if f > 1.0 else f for f in fractions]  # percentages or fractions
    return [DataFileSpec(path, schema, frac) for path, schema, frac in zip(files, schemas, fractions)]


def cmd_train(args) -> int:
    """LoRA / QLoRA (or full) fine-tuning of a causal or seq2seq LM
    (cli/main.py:216-436)."""
    import dataclasses

    from ..data import IGNORE_INDEX, QADataLoader
    from ..models import GenerationConfig, LoraConfig
    from ..train import TrainConfig, Trainer, generative_eval, perplexity_eval

    model = _train_config(args)
    tok = _tokenizer(args.tokenizer)
    if tok.vocab_size > model.vocab_size:
        model = dataclasses.replace(model, vocab_size=tok.vocab_size)
    lora = (LoraConfig(r=args.lora_r, alpha=args.lora_alpha,
                       targets=tuple(args.lora_targets) if args.lora_targets else LoraConfig.targets)
            if args.use_lora else None)
    cfg = TrainConfig(
        model=model, lora=lora, optimizer=args.optimizer, lr=args.lr, weight_decay=args.weight_decay,
        max_grad_norm=args.max_grad_norm, schedule=args.lr_scheduler, warmup_steps=args.warmup_steps,
        epochs=args.epochs, grad_accum=args.grad_accum, strategy=args.strategy,
        mesh_axes=json.loads(args.mesh) if args.mesh else None, host_offload=args.host_offload,
        checkpoint_dir=args.checkpoint_dir, sharded_checkpoint=args.sharded_checkpoint,
        save_every_steps=args.save_every_steps,
        save_every_seconds=args.save_every_seconds, async_checkpoint=args.async_checkpoint, resume=args.resume,
        quantize_base=args.quantize_base, qlora_dequant=args.qlora_dequant, seed=args.seed,
        log_every=args.log_every, log_dir=args.log_dir, report_to=args.report_to, run_name=args.run_name,
        remat=args.remat, profile_steps=args.profile_steps, profile_dir=args.profile_dir,
    )
    dl = QADataLoader(tok, task="seq2seq" if model.arch == "seq2seq" else "causal", max_len=args.max_len,
                      batch_size=args.batch_size, seed=args.seed, pack=args.pack)
    train_examples = dl.load_examples(_file_specs(args.train_files, args.train_schemas, args.train_fractions),
                                      max_examples=args.max_examples, split="train")
    if not train_examples:
        dist_print(f"no training examples loaded (stats: {dl.stats} -- skipped_too_long>0 means --max-len "
                   f"{args.max_len} is too small for prompt+answer)", file=sys.stderr)
        return 2
    eval_examples = (dl.load_examples(_file_specs(args.eval_files, None, None), max_examples=args.max_examples,
                                      split="eval") if args.eval_files else [])
    if args.print_samples:
        shown = 0
        for batch in dl.batches(train_examples, shuffle=False):
            for ids_row, labels_row in zip(batch["input_ids"], batch["labels"]):
                if shown >= args.print_samples:
                    break
                full = tok.decode([t for t in ids_row if t != tok.pad_id])
                target = tok.decode([t for t in labels_row if t not in (IGNORE_INDEX, tok.pad_id)])
                dist_print(f"--- sample {shown} ---\n{full}\n>>> target: {target}")
                shown += 1
            if shown >= args.print_samples:
                break
    if args.pack:
        total_tokens = sum(len(ex["input_ids"]) for ex in train_examples)
        steps_per_epoch = max((total_tokens // args.max_len) // args.batch_size, 1)
    else:
        steps_per_epoch = max(len(train_examples) // args.batch_size, 1)
    init = load_converted_params(args.init_params, model, args.device) if args.init_params else None
    trainer = Trainer(cfg, params=init, total_steps=args.max_steps or steps_per_epoch * args.epochs, device=args.device)

    def train_batches(epoch: int):
        return dl.batches(train_examples, epoch=epoch)

    def eval_fn(rows, epoch):
        metrics = perplexity_eval(rows, model, dl.batches(eval_examples, shuffle=False), mesh=trainer.mesh)
        if args.do_generative_eval:
            # speculation where the JAX CLI takes it (cli/main.py:371-378):
            # no beams, penalties, n-gram bans or minimum length
            plain = (args.num_beams == 1 and args.repetition_penalty == 1.0 and args.no_repeat_ngram_size == 0
                     and args.min_new_tokens == 0)
            gen = GenerationConfig(
                max_new_tokens=args.max_new_tokens, temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
                repetition_penalty=args.repetition_penalty, no_repeat_ngram_size=args.no_repeat_ngram_size,
                min_new_tokens=args.min_new_tokens, num_beams=args.num_beams, length_penalty=args.length_penalty,
                seed=args.seed, speculative=args.speculative if plain else "none", draft_tokens=args.draft_tokens,
                draft_ngram=args.draft_ngram)
            gm = generative_eval(rows, model, tok, _gen_batches(eval_examples, tok, args.batch_size, dl.task),
                                 gen_config=gen, log_dir=os.path.join(args.log_dir, "predictions"), epoch=epoch,
                                 run_name=args.run_name or "model", mesh=trainer.mesh)
            metrics["gen_tokens_per_s"] = gm["gen_tokens_per_s"]
        dist_print(f"eval @ epoch {epoch}: {metrics}", flush=True)
        return metrics

    trainer.fit(train_batches, eval_fn=eval_fn if (args.do_eval and eval_examples) else None,
                max_steps=args.max_steps)
    dist_print(f"training done at step {trainer.global_step}", flush=True)
    if trainer.adapter is not None and args.checkpoint_dir:
        # adapter-only artifact, in the JAX package's layout
        from ..train.checkpoint import save_pytree

        adapter_path = os.path.join(args.checkpoint_dir, "adapter.npz")
        save_pytree(adapter_path, trainer.adapter)
        dist_print(f"adapter saved -> {adapter_path} (r={args.lora_r}, alpha={args.lora_alpha})", flush=True)
    if args.push_to_hub:
        # export the merged weights and push them (offline-safe: a manifest
        # when there is no token or network), logged as a tracker artifact
        from ..train.hub import push_to_hub

        export_dir = os.path.join(args.log_dir, "export")
        _export_npz(trainer.merged_params(), model, export_dir)
        result = push_to_hub(export_dir, args.push_to_hub, dry_run=args.push_dry_run)
        trainer.tracker.log_artifact(export_dir, name=args.push_to_hub)
        if result["pushed"]:
            dist_print(f"pushed to hub repo {args.push_to_hub}")
        else:
            dist_print(f"hub push recorded offline ({result['reason']}) -> {export_dir}/push_manifest.json")
    return 0


def _export_npz(merged, cfg, out_dir: str) -> None:
    """``params.npz`` (the merged model's parameter tree, f32, in the JAX
    order: a quantized base dequantized with the adapter folded in, as
    ``export_tree`` reads it) and ``config.json`` (the ModelConfig) in
    ``out_dir``."""
    from ..models.convert_hf import export_tree
    from ..train.checkpoint import save_pytree

    os.makedirs(out_dir, exist_ok=True)
    save_pytree(os.path.join(out_dir, "params.npz"), export_tree(merged))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())


def cmd_convert_ckpt(args) -> int:
    """Restore a training checkpoint (merging its LoRA adapter) and export
    it as an HF directory or a flat npz (cli/main.py:1050-1116)."""
    from ..models import LoraConfig
    from ..train import TrainConfig, Trainer

    model = _model_config(args)
    lora = (LoraConfig(r=args.lora_r, alpha=args.lora_alpha,
                       targets=tuple(args.lora_targets) if args.lora_targets else LoraConfig.targets)
            if args.use_lora else None)
    cfg = TrainConfig(model=model, lora=lora, optimizer=args.optimizer, checkpoint_dir=args.checkpoint_dir,
                      resume=True, quantize_base=args.quantize_base, seed=args.seed,
                      log_dir=os.path.join(args.out_dir, "_logs"))
    trainer = Trainer(cfg, total_steps=1, device=args.device)
    if trainer.start_step == 0:
        dist_print(f"no checkpoint found under {args.checkpoint_dir}", file=sys.stderr)
        return 2
    merged = trainer.merged_params()
    if args.format == "hf":
        # a quantized base is dequantized (its adapter folded) one layer at
        # a time as it is exported (convert_hf.export_tree)
        if model.arch == "causal":
            from ..models.convert_hf import export_causal_auto

            export_causal_auto(merged, args.out_dir)
        elif model.arch == "seq2seq" and model.seq2seq_family == "t5":
            from ..models.convert_hf import export_t5

            # the exported special-token ids are those of the tokenizer the
            # model was trained with (ByteTokenizer: eos 2; HF t5: eos 1)
            tok = _tokenizer(args.tokenizer)
            export_t5(merged, args.out_dir, pad_token_id=tok.pad_id, eos_token_id=tok.eos_id)
        else:
            dist_print("hf export supports causal and t5-family seq2seq models", file=sys.stderr)
            return 2
    else:
        _export_npz(merged, model, args.out_dir)
    dist_print(f"exported step-{trainer.start_step} model -> {args.out_dir}")
    return 0


def _gen_batches(examples, tok, batch_size: int, task: str = "causal"):
    """LEFT-padded prompt-only batches of the eval examples for generative
    eval (cli/main.py:439-470): each causal example's prompt is its tokens
    before the first supervised label, a seq2seq example's its encoder
    input; the short last batch is kept."""
    import numpy as np

    from ..data import IGNORE_INDEX

    for i in range(0, len(examples), batch_size):
        group = examples[i: i + batch_size]
        prompts = [list(ex["input_ids"]) if task == "seq2seq"
                   else ex["input_ids"][:sum(1 for lab in ex["labels"] if lab == IGNORE_INDEX)] for ex in group]
        width = max(max(len(p) for p in prompts), 1)
        ids = np.full((len(group), width), tok.pad_id, np.int32)
        mask = np.zeros((len(group), width), np.int32)
        for r, pr in enumerate(prompts):
            ids[r, width - len(pr):] = pr
            mask[r, width - len(pr):] = 1
        yield {"input_ids": ids, "attention_mask": mask}


def _add_train_args(p: argparse.ArgumentParser) -> None:
    """The JAX CLI's train flags (cli/main.py:26-155) and --device."""
    g = p.add_argument_group("model")
    g.add_argument("--arch", choices=["causal", "seq2seq"], default="causal")
    g.add_argument("--model-size", default="tiny", choices=[*READERS, *S2S_SIZES],
                   help="preset size (tiny takes --arch)")
    g.add_argument("--model-config", help="path to a ModelConfig json (overrides preset)")
    g.add_argument("--scan-layers", action="store_true",
                   help="homogeneous layers with per-layer remat (the port keeps a list of layers)")
    g.add_argument("--remat-policy", default=None, choices=["full", "dots", "proj_bf16", "none"],
                   help="per-layer remat: full = recompute the layer, dots = save the products and the flash "
                        "outputs, proj_bf16 = save the projections rounded to bf16, none = no remat")
    g.add_argument("--init-params", help="weights to start from: a local HF causal-LM or seq2seq directory, a "
                                         "checkpoint directory or a flat .npz")
    g = p.add_argument_group("lora")
    g.add_argument("--use-lora", action="store_true")
    g.add_argument("--lora-r", type=int, default=8)
    g.add_argument("--lora-alpha", type=int, default=16)
    g.add_argument("--lora-targets", nargs="*", default=None)
    g.add_argument("--quantize-base", choices=["int8", "nf4", "nf4-dq"], default=None,
                   help="quantize the frozen base for LoRA training: int8 blockwise, nf4 (two 4-bit codes a byte), "
                        "nf4-dq (nf4 with double-quantized scales)")
    g.add_argument("--qlora-dequant", choices=["fused", "once", "once_folded"], default="fused",
                   help="dequant placement: at each matmul (fused), or the whole base to bf16 once per microbatch "
                        "before the forward with the LoRA factors applied lazily (once) or folded into the "
                        "weights (once_folded: a full-size weight gradient per layer in the backward)")
    g = p.add_argument_group("optimization")
    g.add_argument("--optimizer", default="adamw", choices=["adamw", "lion", "adamw8bit", "lion8bit"])
    g.add_argument("--lr", type=float, default=2e-4)
    g.add_argument("--weight-decay", type=float, default=0.0)
    g.add_argument("--max-grad-norm", type=float, default=1.0)
    g.add_argument("--lr-scheduler", default="linear", choices=["linear", "cosine", "constant"])
    g.add_argument("--warmup-steps", type=int, default=0)
    g.add_argument("--epochs", type=int, default=1)
    g.add_argument("--max-steps", type=int, default=None)
    g.add_argument("--batch-size", type=int, default=8, help="global batch (= grad-accum * microbatch)")
    g.add_argument("--grad-accum", type=int, default=1)
    g.add_argument("--remat", action="store_true", help="rematerialize the loss (gradient checkpointing)")
    g = p.add_argument_group("distribution")
    g.add_argument("--host-offload", choices=["optimizer", "params", "all"], default=None,
                   help="keep the optimizer state and / or the parameters in (pinned) host memory, staged through "
                        "the device around each step")
    g.add_argument("--strategy", default="dp", choices=["dp", "zero2", "fsdp", "tp", "fsdp_tp"],
                   help="distribution strategy over --mesh (dp on one device without it)")
    g.add_argument("--mesh", default=None,
                   help='mesh axes as json, e.g. \'{"data": 2, "model": 4}\' (--device cpu repeats the host)')
    g = p.add_argument_group("data")
    g.add_argument("--train-files", nargs="+", required=False, default=[])
    g.add_argument("--train-schemas", nargs="*", default=None, help="schema per file: qa|instruct (default instruct)")
    g.add_argument("--train-fractions", nargs="*", type=float, default=None, help="mix fraction per file")
    g.add_argument("--eval-files", nargs="*", default=[])
    g.add_argument("--max-examples", type=int, default=None)
    g.add_argument("--max-len", type=int, default=512)
    g.add_argument("--pack", action="store_true", help="group_texts block packing")
    g.add_argument("--tokenizer", default="byte", help='"byte" or a local HF tokenizer path')
    g = p.add_argument_group("checkpoint / logging")
    g.add_argument("--checkpoint-dir", default=None)
    g.add_argument("--sharded-checkpoint", action="store_true",
                   help="the per-host checkpoint layout (host_0.npz + host_0.layout.json); restore reads either "
                        "layout, and directories the JAX package wrote from several hosts")
    g.add_argument("--save-every-steps", type=int, default=None)
    g.add_argument("--save-every-seconds", type=float, default=None)
    g.add_argument("--async-checkpoint", action="store_true", help="write checkpoints from a background thread")
    g.add_argument("--resume", action="store_true")
    g.add_argument("--log-dir", default="runs/logs")
    g.add_argument("--report-to", default="jsonl", choices=["jsonl", "wandb"],
                   help="wandb when it imports and its run starts, else jsonl")
    g.add_argument("--run-name", default=None)
    g.add_argument("--push-to-hub", default=None, metavar="REPO_ID",
                   help="export the merged model to <log-dir>/export and push it (a push_manifest.json without a "
                        "token or network)")
    g.add_argument("--push-dry-run", action="store_true", help="with --push-to-hub: write the manifest, upload nothing")
    g.add_argument("--log-every", type=int, default=10)
    g.add_argument("--seed", type=int, default=42)
    g = p.add_argument_group("evaluation")
    g.add_argument("--do-eval", action="store_true", help="perplexity over --eval-files after each epoch")
    g.add_argument("--do-generative-eval", action="store_true",
                   help="with --do-eval: also decode the eval prompts and log the predictions under "
                        "<log-dir>/predictions")
    g.add_argument("--max-new-tokens", type=int, default=64)
    g.add_argument("--temperature", type=float, default=0.0)
    g.add_argument("--top-k", type=int, default=0)
    g.add_argument("--top-p", type=float, default=1.0)
    g.add_argument("--repetition-penalty", type=float, default=1.0)
    g.add_argument("--no-repeat-ngram-size", type=int, default=0)
    g.add_argument("--min-new-tokens", type=int, default=0)
    g.add_argument("--num-beams", type=int, default=1)
    g.add_argument("--length-penalty", type=float, default=1.0)
    g.add_argument("--speculative", choices=["none", "ngram"], default="none",
                   help="prompt-lookup speculative decoding for generative eval (greedy: the same tokens; sampled: "
                        "the same distribution); taken without beams, penalties, n-gram bans or a minimum length")
    g.add_argument("--draft-tokens", type=int, default=8)
    g.add_argument("--draft-ngram", type=int, default=3)
    g.add_argument("--print-samples", type=int, default=0, help="decode and print N training examples first")
    g.add_argument("--profile-steps", type=int, default=0,
                   help="write a torch.profiler trace (host operators and GPU kernels) of the first N steps")
    g.add_argument("--profile-dir", default="runs/profile", help="where --profile-steps writes its trace")
    p.add_argument("--device", default="cuda")


def _tokenizer(spec: str):
    from ..data import ByteTokenizer, HFTokenizer

    return ByteTokenizer() if spec == "byte" else HFTokenizer(spec)


def cmd_parse(args) -> int:
    """Run a dataset parser of the offline ETL (cli/main.py:518-529)."""
    from ..etl import get_parser

    cls = get_parser(args.parser)
    kwargs = dict(seed=args.seed, do_translate=args.translate)
    if args.ctx_pool:
        with open(args.ctx_pool) as f:
            kwargs["ctx_pool"] = [line.strip() for line in f if line.strip()]
    parser = cls(args.input, args.output_dir, **kwargs)
    out = parser.run()
    dist_print(f"wrote {parser.stats['converted']} records -> {out}")
    return 0


def _shard_mesh(shards: int, device):
    """``--shards S``: a ``shard`` mesh of S devices (S CPU shards with
    ``--device cpu``; the first S GPUs on the card, raising with fewer, as
    the JAX package's ``create_mesh`` does); None for one shard."""
    from ..core.mesh import SHARD_AXIS, mesh_on

    return mesh_on(device, {SHARD_AXIS: shards}) if shards > 1 else None


def cmd_ingest(args) -> int:
    from ..core.device import resolve_device
    from ..engine import BM25Index, DocStore, IngestPipeline, VectorStore
    from ..etl.parser import load_json_or_jsonl

    device = resolve_device(args.device)
    mesh = _shard_mesh(args.shards, device)
    encoder = _encoder(args.encoder, args.seed, device)
    tok = _tokenizer(args.tokenizer)
    if os.path.exists(os.path.join(args.index, "meta.json")):
        store = VectorStore.load(args.index, device=device, mesh=mesh)
    else:
        store = VectorStore(args.capacity, encoder.cfg.d_model, dtype=args.dtype, device=device, mesh=mesh)
    docstore = DocStore(args.db)
    lexical = None
    bm25_path = os.path.join(args.index, "bm25.json")
    if args.hybrid:
        lexical = BM25Index.load(bm25_path) if os.path.exists(bm25_path) else BM25Index()
    pipe = IngestPipeline(encoder, tok, store, docstore, batch_size=args.batch_size, max_len=args.max_len,
                          lexical=lexical)
    for path in args.inputs:
        rows = load_json_or_jsonl(path)
        docs = [r[args.text_field] if isinstance(r, dict) else str(r) for r in rows]
        ids = pipe.add_documents(docs, [path] * len(docs), chunk_size=args.chunk_size)
        dist_print(f"{path}: ingested {len(ids)} chunks (store size {store.size})")
    store.save(args.index)
    if lexical is not None:
        lexical.save(bm25_path)
        dist_print(f"bm25 term index saved ({lexical.n_docs} docs)")
    dist_print(f"index saved -> {args.index}; docs in {args.db}")
    return 0


def cmd_build_ivf(args) -> int:
    """Cluster a flat index into an IVF index (``serve`` loads either
    directory by its meta.json type)."""
    from ..core.device import resolve_device
    from ..engine import IVFIndex, VectorStore

    device = resolve_device(args.device)
    store = VectorStore.load(args.index, capacity=0, device=device, mesh=_shard_mesh(args.shards, device))
    ivf = IVFIndex.build(store, n_clusters=args.clusters, nprobe=args.nprobe, cap_mult=args.cap_mult,
                         kmeans_iters=args.kmeans_iters, seed=args.seed)
    ivf.save(args.out)
    dist_print(f"IVF index saved -> {args.out}: {ivf.size} vectors, {ivf.n_clusters} clusters x cap {ivf.cap} "
               f"per shard, {ivf.spill_count} spilled ({100.0 * ivf.spill_count / max(ivf.size, 1):.2f}%), "
               f"default nprobe {ivf.nprobe}")
    return 0


def _serving_index(args, device, query_batch: int):
    """The index ``serve`` answers from: ``--index`` as saved (flat or IVF),
    or with ``--ivf-index`` the flat store or the IVF index, by
    ``--index-select`` (``auto``: the card's measured crossover)."""
    from ..engine import IVF_KAPPA, IVFIndex, VectorStore, ivf_crossover_batch, load_index, select_serving_index

    store = load_index(args.index, capacity=args.capacity, device=device)
    if args.ivf_index is not None:
        ivf = load_index(args.ivf_index, device=device)
        if not isinstance(ivf, IVFIndex):
            raise SystemExit(f"--ivf-index {args.ivf_index} is not an IVF directory (build-ivf output)")
        if not isinstance(store, VectorStore):
            raise SystemExit("--index must be the FLAT store when --ivf-index is given")
        if args.index_select == "auto":
            chosen, cross = select_serving_index(store, ivf, query_batch)
        else:
            chosen, cross = (store if args.index_select == "flat" else ivf), None
        kind = "ivf" if chosen is ivf else "flat"
        dist_print(f"index-select: {kind} (query batch {query_batch}"
                   + (f", crossover ~{cross}" if cross is not None else ", forced") + ")", flush=True)
        return chosen
    if isinstance(store, IVFIndex):
        cross = ivf_crossover_batch(store)
        if query_batch > cross:
            dist_print(f"WARNING: IVF index with query batch {query_batch} > crossover ~{cross} (= {store.size} rows / "
                       f"(nprobe {store.nprobe} * cap {store.cap} * {IVF_KAPPA})); the flat scan answers such batches "
                       "faster. Lower --max-batch, rebuild with a smaller build-ivf --nprobe, or pass the flat dir as "
                       "--index with --ivf-index for automatic selection.", flush=True)
    return store


def _sharded_reader(args, reader, device):
    """``serve --reader-strategy tp|fsdp_tp`` (cli/main.py:744-767 of the
    JAX package): the reader -- causal or seq2seq -- split tensor-parallel
    over a ``{"model": n}`` mesh over every visible GPU
    (``CPU_MESH_DEVICES`` repeats of the host with ``--device cpu``); a
    causal one serves ``--adapter`` banks on /generate."""
    from ..core.mesh import CPU_MESH_DEVICES, MODEL_AXIS, mesh_on, visible_devices
    from ..parallel.sharding import shard_params

    if args.reader_quantize:
        raise SystemExit("--reader-strategy shards plain bf16 readers; drop --reader-quantize (int8/nf4 packing "
                         "hides the dims the sharding rules split)")
    n = CPU_MESH_DEVICES if device.type == "cpu" else len(visible_devices())
    mesh = mesh_on(device, {MODEL_AXIS: n})
    sharded = shard_params(reader, mesh, args.reader_strategy)
    dist_print(f"reader sharded: strategy={args.reader_strategy} over {mesh.size} devices", flush=True)
    return sharded


def continuous_engine(args, reader, tok, device):
    """The engine behind ``serve``'s ``/generate``, from its flags
    (cli/main.py:808-865 of the JAX package), with the ``--adapter``
    NAME=PATH adapters (``adapter.npz`` files of either package's ``train
    --use-lora --checkpoint-dir``) in its bank."""
    from ..engine import ContinuousEngine
    from ..models import LoraConfig, load_adapter

    adapters = lcfg = None
    if args.adapter:
        lcfg = LoraConfig(r=args.adapter_r, alpha=args.adapter_alpha,
                          targets=tuple(args.adapter_targets) if args.adapter_targets else LoraConfig.targets)
        adapters = {}
        for spec in args.adapter:
            name, _, path = spec.partition("=")
            if not name or not path:
                raise SystemExit(f"--adapter expects NAME=PATH, got {spec!r}")
            adapters[name] = load_adapter(path, reader, lcfg)
        dist_print(f"adapters loaded: {sorted(adapters)} (r={lcfg.r}, alpha={lcfg.alpha})", flush=True)
    engine = ContinuousEngine(
        reader, reader.cfg, n_slots=args.continuous_slots, total=min(reader.cfg.max_seq_len, args.gen_total),
        chunk_steps=args.gen_chunk_steps, eos_id=tok.eos_id, default_max_new=args.max_new_tokens,
        prefix_cache_mb=args.prefix_cache_mb, speculative=args.gen_speculative, draft_tokens=args.draft_tokens,
        draft_ngram=args.draft_ngram, kv_dtype=args.kv_quant, prefill_chunk=args.prefill_chunk, device=device,
        adapters=adapters, lora_config=lcfg,
    )
    dist_print(f"/generate: continuous batching, {args.continuous_slots} slots x {engine.total} cache, buckets "
               f"{engine.buckets}, chunk {args.gen_chunk_steps}", flush=True)
    return engine


def cmd_serve(args) -> int:
    from ..core.device import resolve_device
    from ..engine import BM25Index, DocStore, IngestPipeline, QAPipeline, Retriever, ServingApp, VectorStore, make_server

    device = resolve_device(args.device)
    encoder = _encoder(args.encoder, args.seed, device)
    tok = _tokenizer(args.tokenizer)
    # in HTTP mode every dispatch pads to query_batch: size it to the
    # micro-batch cap
    qbatch = args.max_batch if args.port is not None else 256
    # shrink-to-fit by default: a query scans the stored corpus, not the
    # build-time headroom; --capacity N leaves room for POST /ingest
    store = _serving_index(args, device, qbatch)
    docstore = DocStore(args.db)
    lexical = None
    bm25_path = os.path.join(args.index, "bm25.json")
    if args.hybrid_weight < 1.0 and os.path.exists(bm25_path):
        lexical = BM25Index.load(bm25_path)
        dist_print(f"hybrid retrieval on (weight {args.hybrid_weight})", flush=True)
    retriever = Retriever(encoder, tok, store, docstore, max_len=args.max_len, lexical=lexical,
                          hybrid_weight=args.hybrid_weight, mode=args.search_mode, query_batch=qbatch)
    qa = None
    if args.reader_size:
        reader = _reader(args.reader_size, tok, args.seed + 1, device, args.reader_quantize, args.reader_params)
        if args.reader_strategy:
            reader = _sharded_reader(args, reader, device)
        draft = None
        if args.speculative == "draft" and reader.cfg.arch == "causal":
            draft = _draft(args.reader_draft_size, reader.cfg.vocab_size, args.seed + 7, device,
                           args.reader_draft_params, "--reader-draft-params")
        qa = QAPipeline(retriever, reader, tok, k=args.k, min_score=args.min_score,
                        max_new_tokens=args.max_new_tokens, speculative=args.speculative,
                        draft_tokens=args.draft_tokens, draft_ngram=args.draft_ngram, draft=draft)
    if args.port is None:
        dist_print(f"index: {store.size} vectors; type a query (empty line quits)")
        while True:
            try:
                query = input("query> ").strip()
            except EOFError:
                break
            if not query:
                break
            if qa is not None:
                ans = qa.answer([query])[0]
                print(f"answer{'(refused)' if ans.refused else ''}> {ans.answer}")
                for rank, (doc, score) in enumerate(zip(ans.contexts, ans.scores)):
                    print(f"  ctx {rank + 1}. score={score:.3f} {doc[:120]}")
                continue
            for rank, r in enumerate(retriever.search([query], k=args.k)[0]):
                doc = (r.doc or "")[:160].replace("\n", " ")
                print(f"  {rank + 1}. [{r.id}] score={r.score:.3f} {doc}")
        return 0

    ingest = IngestPipeline(encoder, tok, store, docstore, batch_size=args.max_batch, max_len=args.max_len,
                            lexical=lexical)
    gen_engine = None
    if args.continuous_slots > 0:
        # raw LM completions: requests join the always-running slot scheduler
        if qa is None:
            raise SystemExit("--continuous-slots needs a reader (--reader-size)")
        gen_engine = continuous_engine(args, reader, tok, device)
    app = ServingApp(retriever, qa, ingest=ingest, gen=gen_engine, tokenizer=tok if gen_engine is not None else None,
                     k=args.k, max_k=args.max_k, max_batch=args.max_batch, max_wait_s=args.batch_wait_ms / 1000.0)
    httpd = make_server(app, host=args.host, port=args.port)
    dist_print(
        f"serving {store.size} vectors on http://{httpd.server_address[0]}:{httpd.server_address[1]} "
        f"(max_batch={args.max_batch}, wait={args.batch_wait_ms}ms; endpoints: /healthz /search /ingest"
        f"{' /qa' if qa else ''}{' /generate' if gen_engine is not None else ''})",
        flush=True,
    )

    def _term(*_):
        # unwinds into the same except/finally as ^C, so /ingest writes persist
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        app.close()
        # only a flat store takes /ingest (an IVF index refuses it), so
        # --index is only ever rewritten with a flat store
        if app.dirty and isinstance(store, VectorStore):
            store.save(args.index)
            if lexical is not None:
                lexical.save(bm25_path)
            dist_print(f"index persisted -> {args.index} ({store.size} vectors)")
    return 0


def cmd_chat(args) -> int:
    """Interactive generation REPL over a causal or seq2seq reader
    (cli/main.py:935-1040)."""
    import torch

    from ..core.device import resolve_device
    from ..data import QUESTION_PREFIX, RESPONSE_PREFIX, batch_encode
    from ..models import GenerationConfig, generate_with_config

    device = resolve_device(args.device)
    tok = _tokenizer(args.tokenizer)
    model = _reader(args.model_size, tok, args.seed, device, args.quantize, args.init_params, args.arch)
    is_s2s = model.cfg.arch == "seq2seq"
    # speculation decodes causal readers without beams (cli/main.py:979-1032)
    use_spec = args.speculative != "none" and not is_s2s and args.num_beams == 1
    draft = None
    if use_spec and args.speculative == "draft":
        draft = _draft(args.draft_size, model.cfg.vocab_size, args.seed + 7, device, args.draft_params,
                       "--draft-params")
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens, temperature=args.temperature, num_beams=args.num_beams,
                           speculative=args.speculative if use_spec else "none", draft_tokens=args.draft_tokens,
                           draft_ngram=args.draft_ngram)
    dist_print("chat REPL — empty line quits", flush=True)
    while True:
        try:
            text = input("user> ").strip()
        except EOFError:
            break
        if not text:
            break
        prompt = f"{QUESTION_PREFIX}\n{text}\n\n{RESPONSE_PREFIX}\n"
        # a seq2seq encoder takes right padding and answers with new tokens only
        ids, mask = batch_encode(tok, [prompt], args.max_len, pad_side="right" if is_s2s else "left")
        out = generate_with_config(model, torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device),
                                   gen, eos_id=tok.eos_id, draft=draft)
        new_tokens = (out[0] if is_s2s else out[0, ids.shape[1]:]).tolist()
        print(f"model> {tok.decode([t for t in new_tokens if t not in (tok.pad_id, tok.eos_id)])}", flush=True)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vietnamese_qa_system_tpu_torch",
                                description="Vietnamese QA (retrieval and reader) on PyTorch / CUDA")
    sub = p.add_subparsers(dest="command", required=True)

    pt = sub.add_parser("train", help="fine-tune a causal LM (LoRA / QLoRA)")
    _add_train_args(pt)
    pt.set_defaults(fn=cmd_train)

    pp = sub.add_parser("parse", help="run a dataset parser (offline ETL)")
    pp.add_argument("--parser", required=True)
    pp.add_argument("--input", required=True)
    pp.add_argument("--output-dir", required=True)
    pp.add_argument("--translate", action="store_true")
    pp.add_argument("--ctx-pool", default=None, help="file of passages for random context injection")
    pp.add_argument("--seed", type=int, default=42)
    pp.set_defaults(fn=cmd_parse)

    pi = sub.add_parser("ingest", help="build the retrieval index")
    pi.add_argument("--inputs", nargs="+", required=True)
    pi.add_argument("--text-field", default="doc")
    pi.add_argument("--index", required=True)
    pi.add_argument("--db", required=True)
    pi.add_argument("--encoder", default="tiny", help="preset (tiny | minilm | mpnet) or a local HF BERT / MPNet "
                                                     "directory")
    pi.add_argument("--tokenizer", default="byte")
    pi.add_argument("--capacity", type=int, default=1 << 20)
    pi.add_argument("--dtype", default="bf16", choices=["bf16", "int8", "int8_global", "int8_res"],
                    help="index compression: int8 halves memory; int8_res keeps bf16-equal memory but "
                         "scans half the bytes, a two-stage re-rank restores recall")
    pi.add_argument("--shards", type=int, default=1,
                    help="shard the store round-robin over S devices (the first S GPUs, or S CPU shards with "
                         "--device cpu)")
    pi.add_argument("--chunk-size", type=int, default=512)
    pi.add_argument("--batch-size", type=int, default=256)
    pi.add_argument("--max-len", type=int, default=128)
    pi.add_argument("--hybrid", action="store_true", help="also build a BM25 term index (bm25.json in --index)")
    pi.add_argument("--seed", type=int, default=42)
    pi.add_argument("--device", default="cuda")
    pi.set_defaults(fn=cmd_ingest)

    pf = sub.add_parser("build-ivf", help="cluster a flat index into an IVF index")
    pf.add_argument("--index", required=True, help="flat index dir (ingest)")
    pf.add_argument("--out", required=True, help="output IVF index dir")
    pf.add_argument("--clusters", type=int, default=None, help="cluster count (default ~4*sqrt(N))")
    pf.add_argument("--nprobe", type=int, default=8)
    pf.add_argument("--cap-mult", type=float, default=1.6)
    pf.add_argument("--kmeans-iters", type=int, default=10)
    pf.add_argument("--shards", type=int, default=1,
                    help="shards of the IVF index (the flat store is re-laid onto them); one a GPU, or S CPU shards "
                         "with --device cpu")
    pf.add_argument("--seed", type=int, default=0)
    pf.add_argument("--device", default="cuda")
    pf.set_defaults(fn=cmd_build_ivf)

    ps = sub.add_parser("serve", help="retrieval (or QA with --reader-size) REPL, or the HTTP API with --port")
    ps.add_argument("--index", required=True)
    ps.add_argument("--ivf-index", default=None,
                    help="IVF directory (build-ivf) over the same corpus as --index (the flat store); serve then "
                         "picks per query batch: IVF up to the measured crossover, flat past it")
    ps.add_argument("--index-select", default="auto", choices=["auto", "flat", "ivf"],
                    help="override the automatic IVF/flat choice when --ivf-index is given")
    ps.add_argument("--db", required=True)
    ps.add_argument("--capacity", type=int, default=0,
                    help="index capacity at serve time: 0 = shrink to the stored corpus; larger leaves "
                         "headroom for POST /ingest")
    ps.add_argument("--encoder", default="tiny", help="preset (tiny | minilm | mpnet) or a local HF BERT / MPNet "
                                                     "directory")
    ps.add_argument("--tokenizer", default="byte")
    ps.add_argument("--k", type=int, default=5)
    ps.add_argument("--max-len", type=int, default=128)
    ps.add_argument("--seed", type=int, default=42)
    ps.add_argument("--port", type=int, default=None,
                    help="serve the HTTP JSON API on this port instead of the REPL (0 = ephemeral)")
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--max-batch", type=int, default=32, help="max requests fused into one dispatch")
    ps.add_argument("--max-k", type=int, default=None, help="largest per-request k the API accepts")
    ps.add_argument("--batch-wait-ms", type=float, default=5.0,
                    help="how long a batch waits for co-riders after its first request")
    ps.add_argument("--hybrid-weight", type=float, default=0.5,
                    help="dense weight in hybrid fusion; below 1 an index with a bm25.json (ingest --hybrid) "
                         "serves hybrid BM25 + dense retrieval")
    ps.add_argument("--search-mode", default="fast", choices=["fast", "turbo"],
                    help="kept for parity with the JAX CLI: every mode of the port is exact")
    ps.add_argument("--reader-size", default=None, choices=[*READERS, *S2S_READERS],
                    help="enable full QA (/qa): retrieve + generate with a reader LM of this preset, causal or "
                         "seq2seq (tiny-s2s, mt5small) (weights from --reader-params, else random from --seed)")
    ps.add_argument("--reader-quantize", choices=["int8", "int8c", "nf4", "nf4-dq"], default=None,
                    help="quantize the reader's dense weights for decode; int8c (one scale per output channel) "
                         "decodes through the w8 GEMM kernel (K6); int8, nf4 and nf4-dq are dequantized at each "
                         "matmul")
    ps.add_argument("--min-score", type=float, default=0.2,
                    help="retrieval score below which /qa refuses instead of answering")
    ps.add_argument("--max-new-tokens", type=int, default=128,
                    help="completion budget of each /qa answer, and the default one of /generate")
    ps.add_argument("--speculative", choices=["none", "ngram", "draft"], default="ngram",
                    help="speculative decoding of /qa: ngram = prompt lookup (RAG answers quote their contexts, so "
                         "drafts hit often), draft = a small draft model (--reader-draft-size / -params)")
    ps.add_argument("--reader-params", default=None,
                    help="reader weights: a local HF causal-LM or seq2seq directory, a checkpoint directory or a "
                         "flat .npz")
    ps.add_argument("--reader-strategy", choices=["tp", "fsdp_tp"], default=None,
                    help="split the reader tensor-parallel (attention heads, MLP hidden, vocabulary) over the "
                         "model axis; plain float readers only")
    ps.add_argument("--reader-draft-size", default="tiny", choices=DRAFTS,
                    help="draft model preset for --speculative draft")
    ps.add_argument("--reader-draft-params", default=None,
                    help="draft model weights: a local HF causal-LM directory, a checkpoint directory or a flat .npz")
    ps.add_argument("--continuous-slots", type=int, default=0,
                    help="enable POST /generate via continuous batching with this many decode slots (needs "
                         "--reader-size and --port; 0 = off)")
    ps.add_argument("--gen-total", type=int, default=1024,
                    help="per-slot KV cache length for /generate (capped at the reader's max_seq_len)")
    ps.add_argument("--gen-chunk-steps", type=int, default=16,
                    help="decode steps per dispatch between host harvests on /generate")
    ps.add_argument("--prefix-cache-mb", type=float, default=0.0,
                    help="keep prompt KV on the device and prefill only the suffix of later /generate prompts "
                         "that share a prefix; 0 = off")
    ps.add_argument("--gen-speculative", choices=["off", "ngram"], default="ngram",
                    help="prompt-lookup speculative decoding inside the continuous engine (while every request "
                         "is greedy; a sampled one sends the batch to plain chunks)")
    ps.add_argument("--draft-tokens", type=int, default=8,
                    help="drafted tokens per speculative step (/qa and /generate)")
    ps.add_argument("--draft-ngram", type=int, default=3,
                    help="n-gram length of the prompt-lookup draft (/qa and /generate)")
    ps.add_argument("--kv-quant", choices=["bf16", "int8"], default="bf16",
                    help="KV-cache storage for /generate: int8 codes with per-(token, head) scales folded into "
                         "the attention (streams match generate(kv_dtype='int8'))")
    ps.add_argument("--prefill-chunk", type=int, default=0,
                    help="admit long /generate prompts in pieces of this many tokens (a prompt bucket; 0 = "
                         "whole-prompt prefill): live requests keep decoding between pieces")
    ps.add_argument("--adapter", action="append", default=None, metavar="NAME=PATH",
                    help="serve a LoRA adapter.npz (from train --use-lora --checkpoint-dir) under NAME on /generate; "
                         "repeatable: every adapter shares the reader's weights (multi-LoRA serving)")
    ps.add_argument("--adapter-r", type=int, default=8)
    ps.add_argument("--adapter-alpha", type=int, default=16)
    ps.add_argument("--adapter-targets", nargs="*", default=None)
    ps.add_argument("--device", default="cuda")
    ps.set_defaults(fn=cmd_serve)

    pc = sub.add_parser("chat", help="interactive generation REPL")
    pc.add_argument("--arch", choices=["causal", "seq2seq"], default="causal")
    pc.add_argument("--model-size", default="tiny", choices=[*READERS, *S2S_SIZES], help="preset size (tiny takes "
                                                                                      "--arch)")
    pc.add_argument("--tokenizer", default="byte")
    pc.add_argument("--max-len", type=int, default=256)
    pc.add_argument("--max-new-tokens", type=int, default=128)
    pc.add_argument("--temperature", type=float, default=0.0)
    pc.add_argument("--num-beams", type=int, default=1)
    pc.add_argument("--quantize", choices=["int8", "int8c", "nf4", "nf4-dq"], default=None,
                    help="quantize dense weights for decode; int8c decodes through the w8 GEMM kernel (K6); int8, "
                         "nf4 and nf4-dq are dequantized at each matmul")
    pc.add_argument("--init-params", default=None,
                    help="model weights: a local HF causal-LM or seq2seq directory, a checkpoint directory or a flat "
                         ".npz")
    pc.add_argument("--speculative", choices=["none", "ngram", "draft"], default="ngram",
                    help="speculative decoding: ngram = prompt lookup, draft = a small draft model (--draft-size / "
                         "--draft-params); greedy gives the same tokens, sampling the same distribution; without "
                         "beams only")
    pc.add_argument("--draft-tokens", type=int, default=8)
    pc.add_argument("--draft-ngram", type=int, default=3)
    pc.add_argument("--draft-size", default="tiny", choices=DRAFTS, help="draft model preset for --speculative draft")
    pc.add_argument("--draft-params", default=None,
                    help="draft model weights: a local HF causal-LM directory, a checkpoint directory or a flat .npz")
    pc.add_argument("--seed", type=int, default=42)
    pc.add_argument("--device", default="cuda")
    pc.set_defaults(fn=cmd_chat)

    pv = sub.add_parser("convert-ckpt", help="checkpoint -> exported model (an HF directory or a flat npz)")
    pv.add_argument("--checkpoint-dir", required=True)
    pv.add_argument("--out-dir", required=True)
    pv.add_argument("--format", default="hf", choices=["hf", "npz"])
    pv.add_argument("--arch", choices=["causal", "seq2seq"], default="causal")
    pv.add_argument("--model-size", default="tiny", choices=[*READERS, *S2S_SIZES])
    pv.add_argument("--tokenizer", default="byte",
                    help="tokenizer the checkpoint was trained with; sets the exported special-token ids (t5 export)")
    pv.add_argument("--model-config", default=None)
    pv.add_argument("--use-lora", action="store_true")
    pv.add_argument("--lora-r", type=int, default=8)
    pv.add_argument("--lora-alpha", type=int, default=16)
    pv.add_argument("--lora-targets", nargs="*", default=None)
    pv.add_argument("--quantize-base", choices=["int8", "nf4", "nf4-dq"], default=None,
                    help="the checkpoint was trained with this base quantization; weights are dequantized for export")
    pv.add_argument("--optimizer", default="adamw", choices=["adamw", "lion", "adamw8bit", "lion8bit"])
    pv.add_argument("--seed", type=int, default=42)
    pv.add_argument("--device", default="cuda")
    pv.set_defaults(fn=cmd_convert_ckpt)
    return p


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
