"""Command-line interface: ``python -m tpualign_torch <command>``.

``run`` (the whole pipeline, from raw manuals to ``metrics.json``, with
``--skip-*``, ``--force`` and ``--non-interactive``), the stages
``process``, ``filter``, ``setup-db``, ``embed`` and ``evaluate``,
``check``, ``serve``, ``query``, ``index``, ``ingest`` (incremental, with
``--evaluate`` and ``--notify``) and ``watch`` (``--interval``,
``--max-cycles``) and ``train`` (fine-tuning on a schema's pairs, with
``--ckpt-dir``, LoRA, distillation and held-out evaluation) and
``calibrate`` (the weak scores mapped onto the towers' cosine scale,
``--write`` to store them) are tpualign's, with the same flags, environment
keys and output. The commands that compute run on the GPU unless ``--device
cpu`` is given; ``process``, ``filter`` and ``calibrate`` are host work and
take no device. ``--mesh-data``/``--mesh-model`` (``MESH_DATA``/``MESH_MODEL``)
give ``run``, ``setup-db``, ``embed``, ``evaluate``, ``ingest``, ``watch``,
``serve`` and ``train`` tpualign's ``default_mesh``: the visible cards in
order (with ``--device cpu``, the CPU device repeated, as the CPU tests'
meshes are): the batches split over ``data``, the towers tensor parallel
over ``model`` (``embed``, ``serve``, ``train``), and ``train`` with
``TRAIN_FSDP=1`` splits the parameters, moments and EMA over ``data`` too.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

from tpualign_torch.config import load_config
from tpualign_torch.store import SCHEMAS


def _add_common(p: argparse.ArgumentParser, device: bool = True) -> None:
    p.add_argument("--env-file", default=".env", help="env file with configuration")
    p.add_argument("--input-dir", default=None)
    p.add_argument("--output-dir", default=None)
    p.add_argument("--store-dir", default=None)
    p.add_argument("--model", default=None, help="CLIP model name (e.g. ViT-B-32)")
    p.add_argument("--language", default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--mesh-data", type=int, default=None)
    p.add_argument("--mesh-model", type=int, default=None)
    if device:
        p.add_argument("--device", default="cuda",
                       help="cuda (the default) or cpu, where the kernels' plain versions run")


def _config_from(args):
    overrides = {}
    for attr, env in (("input_dir", "INPUT_DIR"), ("output_dir", "OUTPUT_DIR"),
                      ("store_dir", "STORE_DIR"), ("model", "CLIP_MODEL"),
                      ("language", "LANGUAGE"), ("batch_size", "BATCH_SIZE"),
                      ("mesh_data", "MESH_DATA"), ("mesh_model", "MESH_MODEL"),
                      ("exclude_file", "EXCLUDE_TERMS_FILE"),
                      ("lora_rank", "LORA_RANK"), ("lora_alpha", "LORA_ALPHA"),
                      ("distill_from", "DISTILL_CHECKPOINT"),
                      ("distill_model", "DISTILL_MODEL"),
                      ("distill_weight", "DISTILL_WEIGHT")):
        v = getattr(args, attr, None)
        if v is not None:
            overrides[env] = str(v)
    return load_config(overrides, env_file=args.env_file)


def _mesh(config, device: str):
    """tpualign's ``default_mesh(config.mesh)`` where ``MESH_DATA`` x
    ``MESH_MODEL`` is above 1, else None; on ``--device cpu`` the mesh
    repeats the CPU device."""
    if config.mesh.num_devices <= 1:
        return None
    from tpualign_torch.parallel.mesh import create_mesh, default_mesh

    if device == "cpu":
        return create_mesh(config.mesh.data, config.mesh.model,
                           devices=["cpu"] * config.mesh.num_devices)
    return default_mesh(config.mesh)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tpualign_torch",
        description="tpualign on an NVIDIA GPU: process manuals, embed them into the store, "
                    "evaluate, index, serve and query it",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_run = sub.add_parser("run", help="run the complete pipeline")
    _add_common(p_run)
    p_run.add_argument("--skip-pdf", action="store_true", help="skip document processing")
    p_run.add_argument("--skip-lexical", action="store_true", help="skip lexical filtering")
    p_run.add_argument("--skip-db", action="store_true", help="skip store setup")
    p_run.add_argument("--skip-embeddings", action="store_true", help="skip embedding insertion")
    p_run.add_argument("--skip-eval", action="store_true", help="skip evaluation")
    p_run.add_argument("--force", action="store_true", help="re-run all steps")
    p_run.add_argument("--non-interactive", action="store_true",
                       help="no operator pause during lexical filtering")

    p_proc = sub.add_parser("process", help="stage 1: document processing only")
    _add_common(p_proc, device=False)

    p_filter = sub.add_parser("filter", help="stage 2: lexical filtering only")
    _add_common(p_filter, device=False)
    p_filter.add_argument("--exclude-file", default=None,
                          help="operator exclusion list (one term per line)")

    p_setup = sub.add_parser("setup-db", help="stage 3: create store schemas")
    _add_common(p_setup)
    p_setup.add_argument("--force", action="store_true")

    p_embed = sub.add_parser("embed", help="stage 4: embed + weak supervision")
    _add_common(p_embed)
    p_embed.add_argument("schema", nargs="?", default=None,
                         help=f"one of {', '.join(SCHEMAS)}; omit for all")
    p_embed.add_argument("--force", action="store_true")

    p_eval = sub.add_parser("evaluate", help="stage 5: metrics + charts")
    _add_common(p_eval)

    p_ingest = sub.add_parser("ingest",
                              help="incremental ingestion: process new/changed files only")
    _add_common(p_ingest)
    p_ingest.add_argument("--evaluate", action="store_true",
                          help="re-run evaluation after ingesting")
    p_ingest.add_argument("--notify", metavar="URL", default=None,
                          help="POST /sync to a running serve after ingesting "
                               "(incremental pickup)")

    p_watch = sub.add_parser("watch", help="watchdog: poll the input dir and ingest on change")
    _add_common(p_watch)
    p_watch.add_argument("--interval", type=float, default=30.0,
                         help="poll interval in seconds")
    p_watch.add_argument("--evaluate", action="store_true")
    p_watch.add_argument("--notify", metavar="URL", default=None,
                         help="POST /sync to a running serve after each ingesting cycle")
    p_watch.add_argument("--max-cycles", type=int, default=None,
                         help="stop after N cycles (default: run forever)")

    p_check = sub.add_parser("check", help="installation/store diagnostics")
    _add_common(p_check, device=False)

    p_train = sub.add_parser("train", help="weak-supervision-weighted contrastive fine-tuning")
    _add_common(p_train)
    p_train.add_argument("--schema", default="clip_combined", choices=list(SCHEMAS))
    p_train.add_argument("--steps", type=int, default=100)
    p_train.add_argument("--train-batch-size", type=int, default=None)
    p_train.add_argument("--ckpt-dir", default=None)
    p_train.add_argument("--lora-rank", type=int, default=None,
                         help="LoRA rank (>0: freeze base, train adapters)")
    p_train.add_argument("--lora-alpha", type=float, default=None,
                         help="LoRA merge strength (scale = alpha/rank)")
    p_train.add_argument("--distill-from", default=None,
                         help="teacher checkpoint: train the (smaller) student to match its "
                              "retrieval structure")
    p_train.add_argument("--distill-model", default=None,
                         help="teacher model name (default: the student's)")
    p_train.add_argument("--distill-weight", type=float, default=None,
                         help="KD mix weight in [0,1]; 1.0 = pure distill")
    p_train.add_argument("--eval-every", type=int, default=0,
                         help="held-out retrieval eval every N steps")
    p_train.add_argument("--metrics-file", default=None,
                         help="append one JSON line per log interval (training history for "
                              "dashboards)")
    p_train.add_argument("--log-every", type=int, default=10,
                         help="steps between progress logs / metric lines")
    p_train.add_argument("--eval-fraction", type=float, default=0.0,
                         help="fraction of pairs held out for validation")

    p_serve = sub.add_parser(
        "serve", help="retrieval daemon: device-resident index over HTTP/JSON")
    _add_common(p_serve)
    p_serve.add_argument(
        "--schema", default="vanilla_clip",
        help="schema to serve; a comma list or 'all' serves several schemas from one "
             "endpoint (requests route by their 'schema' field; the first listed, or "
             "vanilla_clip for 'all', is the default), sharing one tower pair")
    p_serve.add_argument("--host", default="127.0.0.1")
    p_serve.add_argument("--port", type=int, default=8321)
    p_serve.add_argument("--no-text-tower", action="store_true",
                         help="skip loading the towers (embedding-only queries)")

    p_query = sub.add_parser("query", help="similarity search over the store")
    _add_common(p_query)
    p_query.add_argument("--schema", default="vanilla_clip", choices=list(SCHEMAS))
    p_query.add_argument("--image-id", default=None,
                         help="rank text chunks for this stored image")
    p_query.add_argument("--text", default=None, help="rank stored images for this text query")
    p_query.add_argument("-k", type=int, default=10)
    p_query.add_argument("--global", dest="global_search", action="store_true",
                         help="search the whole corpus instead of the same-manual+page "
                              "candidate set")
    p_query.add_argument("--rerank", type=float, default=None, metavar="ALPHA",
                         help="blend weak-supervision scores into the ranking: "
                              "(1-ALPHA)*cosine + ALPHA*weak_score")

    p_cal = sub.add_parser("calibrate",
                           help="calibrate weak-supervision scores onto the tower cosine scale")
    _add_common(p_cal, device=False)
    p_cal.add_argument("--schema", default="clip_combined", choices=list(SCHEMAS))
    p_cal.add_argument("--write", action="store_true",
                       help="upsert calibrated scores back into the store")

    p_index = sub.add_parser(
        "index", help="build + persist the IVF retrieval index offline (the reference built "
                      "its ANN index at setup time)")
    _add_common(p_index)
    p_index.add_argument("--schema", default="vanilla_clip", choices=list(SCHEMAS))
    p_index.add_argument("--cache", default=None,
                         help="artifact path (default: IVF_CACHE from the config, else "
                              "<store>/<schema>.ivf.npz)")

    args = parser.parse_args(argv)
    if args.command in ("run", "process", "filter", "setup-db", "embed", "evaluate"):
        return _run_stage(args)
    if args.command in ("ingest", "watch"):
        return _run_ingest(args)
    if args.command == "check":
        from tpualign_torch.utils.checks import run_checks

        return run_checks(_config_from(args))
    if args.command == "train":
        return _run_train(args)
    if args.command == "serve":
        return _run_serve(args)
    if args.command == "index":
        return _run_index(args)
    if args.command == "calibrate":
        return _run_calibrate(args)
    return _run_query(args)


def _run_stage(args) -> int:
    """The pipeline's stages, as ``tpualign run|process|filter|setup-db|
    embed|evaluate``. The stages log a schema's failure and go on with the
    next, as tpualign's do; the exit code is 1 when a schema failed to fill
    (``embed``, ``run``) or has no metrics (``evaluate``, ``run``)."""
    from tpualign_torch.pipeline import Pipeline

    if args.command == "embed" and args.schema is not None and args.schema not in SCHEMAS:
        print(f"Unknown schema: {args.schema}")
        print(f"Available schemas: {', '.join(SCHEMAS)}")
        return 1
    # stages 1-2 are host work and touch no device
    config = _config_from(args)
    device = getattr(args, "device", "cpu")
    pipe = Pipeline(config, device=device,
                    mesh=_mesh(config, device) if hasattr(args, "device") else None)
    if args.command == "process":
        pipe.step_document_processing(force=True)
        return 0
    if args.command == "filter":
        pipe.step_lexical_filtering(force=True, non_interactive=True)
        return 0
    if args.command == "setup-db":
        pipe.step_store_setup(force=args.force)
        return 0
    if args.command == "run":
        failed = pipe.run(skip_pdf=args.skip_pdf, skip_lexical=args.skip_lexical,
                          skip_db=args.skip_db, skip_embeddings=args.skip_embeddings,
                          skip_eval=args.skip_eval, force=args.force,
                          non_interactive=args.non_interactive)
    elif args.command == "embed":
        failed = pipe.step_insert_embeddings(force=args.force,
                                             schemas=[args.schema] if args.schema else None)
    else:
        failed = pipe.unevaluated(pipe.step_evaluation())
    if failed:
        print(f"tpualign_torch {args.command}: failed for {', '.join(failed)}; "
              "see the errors above", file=sys.stderr)
        return 1
    return 0


def _run_train(args) -> int:
    """Fine-tune on ``--schema``'s pairs and print the final metrics, as
    ``tpualign train`` does: on one device, or on ``--mesh-data`` x
    ``--mesh-model`` devices (``Trainer(mesh=)``)."""
    from tpualign_torch.train.trainer import Trainer

    config = _config_from(args)
    trainer = Trainer(config, mesh=_mesh(config, args.device), device=args.device)
    metrics = trainer.train(schema=args.schema, steps=args.steps,
                            batch_size=args.train_batch_size, ckpt_dir=args.ckpt_dir,
                            eval_every=args.eval_every, eval_fraction=args.eval_fraction,
                            metrics_file=args.metrics_file, log_every=args.log_every)
    print({k: (round(v, 4) if isinstance(v, float) else v) for k, v in metrics.items()})
    return 0


def _run_ingest(args) -> int:
    """``ingest`` (one incremental cycle, then ``POST /sync`` to
    ``--notify``) and ``watch`` (cycles every ``--interval`` seconds), as
    tpualign's."""
    from tpualign_torch.pipeline import Pipeline, notify_sync

    config = _config_from(args)
    pipe = Pipeline(config, device=args.device, mesh=_mesh(config, args.device))
    if args.command == "watch":
        try:
            pipe.watch(interval_seconds=args.interval, evaluate=args.evaluate,
                       max_cycles=args.max_cycles, notify=args.notify)
        except KeyboardInterrupt:
            pass
        return 0
    summary = pipe.ingest_cycle(evaluate=args.evaluate)
    ingested = summary.get("ingested", [])
    if ingested and args.notify:
        notify_sync(args.notify, token=pipe.config.serve_token)
    print(f"ingested {len(ingested)} file(s); {summary.get('skipped_unchanged', 0)} unchanged")
    return 0


def _run_index(args) -> int:
    """Build (or load) the schema's IVF or HNSW artifact and print one
    JSON line with its geometry, as ``tpualign index`` does."""
    from tpualign_torch.serving.server import build_index_artifact, schema_cache_path

    config = _config_from(args)
    kind = getattr(config, "retrieval_index", "exact")
    if kind == "exact":
        kind = "ivf"  # exact search has no offline artifact
    cache = schema_cache_path(
        args.cache or (getattr(config, "hnsw_cache", None) if kind == "hnsw"
                       else getattr(config, "ivf_cache", None))
        or os.path.join(config.store.root, f"{args.schema}.{kind}.npz"), args.schema)
    index = build_index_artifact(config, args.schema, cache, device=args.device)
    info = {"schema": args.schema, "index": kind, "cache": cache, "n": index.n,
            "precision": index.precision}
    if kind == "hnsw":
        info.update({"m": index.m, "ef_construction": index.ef_construction,
                     "ef_search": index.ef_search, "memory_bytes": index.memory_bytes()})
    else:
        info.update({"n_lists": index.n_lists, "n_probes": index.n_probes,
                     "capacity": index.capacity, "spill": index.spill,
                     "calibrated_target": getattr(index, "calibrated_target", None)})
    print(json.dumps(info))
    return 0


def _run_calibrate(args) -> int:
    """Fit the schema's weak scores onto the stored pairs' cosine
    (isotonic) and print the ranges; ``--write`` stores the calibrated
    scores. Exit 1 on a schema without alignments, as tpualign's."""
    from tpualign_torch.store import EmbeddingStore
    from tpualign_torch.weaksup.calibration import calibrate_schema

    config = _config_from(args)
    store = EmbeddingStore(config.store.root, embed_dim=config.model.variant.embed_dim)
    out = calibrate_schema(store, args.schema, write=args.write)
    if out["n_pairs"] == 0:
        print(f"no alignments in schema {args.schema}")
        return 1
    print(f"calibrated {out['n_pairs']} pairs: "
          f"raw {out['raw_range'][0]:.3f}..{out['raw_range'][1]:.3f} -> "
          f"cosine {out['calibrated_range'][0]:.3f}..{out['calibrated_range'][1]:.3f}"
          + (" (written)" if args.write else " (dry run; --write to persist)"))
    return 0


def _run_serve(args) -> int:
    from tpualign_torch.serving.server import (
        _ServiceBox, build_service, fetch_snapshot, make_engine, make_image_bytes_encoder,
        serve_schemas)
    from tpualign_torch.store import EmbeddingStore

    config = _config_from(args)
    mesh = _mesh(config, args.device)
    if args.schema == "all":
        schemas = list(SCHEMAS)
    else:
        schemas = [s.strip() for s in args.schema.split(",") if s.strip()]
        bad = [s for s in schemas if s not in SCHEMAS]
        if bad:
            print(f"unknown schema(s) {bad}; choose from {list(SCHEMAS)}")
            return 1
    # check the store before paying for the towers
    probe = EmbeddingStore(config.store.root, embed_dim=config.model.variant.embed_dim)
    missing = [s for s in schemas if not probe.has_embeddings(s)]
    if missing and args.schema != "all":
        print(f"error: schema(s) {missing} have no embeddings in {config.store.root}")
        return 1
    for s in missing:
        print(f"skipping {s}: no embeddings in {config.store.root}")
    schemas = [s for s in schemas if s not in missing]
    if not schemas:
        print(f"no schema has embeddings in {config.store.root}")
        return 1

    encoder = img_encoder = None
    if not args.no_text_tower:
        engine = make_engine(config, args.device, mesh)
        encoder = engine.encode_text_batch
        img_encoder = make_image_bytes_encoder(engine)

    boxes = {}
    for schema in schemas:
        try:
            service = build_service(config, schema, mesh=mesh, encoder=encoder,
                                    image_encoder=img_encoder,
                                    text_tower=not args.no_text_tower, device=args.device)
        except ValueError as e:
            # configuration errors exit cleanly, not with a traceback
            print(f"error building {schema}: {e}")
            return 1
        boxes[schema] = _ServiceBox(
            service,
            rebuild=lambda s=schema: build_service(
                config, s, mesh=mesh, encoder=encoder, image_encoder=img_encoder,
                text_tower=not args.no_text_tower, device=args.device),
            fetch=lambda s=schema: fetch_snapshot(config, s))
    default = schemas[0]
    httpd = serve_schemas(boxes, default, host=args.host, port=args.port,
                          token=config.serve_token, idle_timeout=config.serve_idle_timeout,
                          max_body_bytes=config.serve_max_body_bytes,
                          max_connections=config.serve_max_connections,
                          request_deadline=config.serve_request_deadline)
    print(f"tpualign_torch serve [{', '.join(sorted(boxes))}; default {default}]: "
          f"{boxes[default].service.stats()} on "
          f"http://{args.host}:{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


def _run_query(args) -> int:
    from tpualign_torch.parallel.retrieval import RetrievalIndex, build_index
    from tpualign_torch.serving.server import index_kwargs, make_engine
    from tpualign_torch.store import EmbeddingStore

    config = _config_from(args)
    store = EmbeddingStore(config.store.root, embed_dim=config.model.variant.embed_dim)
    schema = args.schema
    if not store.has_embeddings(schema):
        print(f"schema {schema} has no embeddings (run `tpualign embed` first)")
        return 1

    if args.image_id:
        # top chunks for an image, candidates restricted to the image's
        # manual+page unless --global
        images = store.images(schema)
        img_ids, img_emb = store.embedding_matrix(schema, "images")
        chunk_ids, chunk_emb = store.embedding_matrix(schema, "text_chunks")
        chunks = store.chunks(schema)
        try:
            pos = img_ids.index(args.image_id)
        except ValueError:
            print(f"unknown image_id {args.image_id}")
            return 1
        img = images[pos]
        kw = index_kwargs(config, schema)
        # an ivf/hnsw artifact is honoured only where it exists (`index`
        # builds it): a one-shot query never pays a k-means build it cannot
        # keep, and searches exactly instead, as tpualign does
        has_artifact = any(kw["index_type"] == t and kw[f"{t}_cache"]
                           and os.path.exists(kw[f"{t}_cache"]) for t in ("ivf", "hnsw"))
        if kw["index_type"] != "exact" and not has_artifact:
            print(f"(no prebuilt {kw['index_type']} artifact — run `tpualign index` to "
                  f"create one; using exact search)")
            kw["index_type"] = "exact"
            if kw["precision"] == "fp16":  # the hnsw-only rung
                kw["precision"] = "fp32"
        index = build_index(chunk_emb, [c["manual_id"] for c in chunks],
                            [c.get("page") for c in chunks], device=args.device, **kw)
        vals, idx = index.search(img_emb[pos:pos + 1], [img["manual_id"]], [img.get("page")],
                                 args.k, global_search=args.global_search)
        label = "sim"
        if args.rerank is not None:
            from tpualign_torch.weaksup.rerank import build_weak_lookup, rerank_with_weak_scores

            lookup = build_weak_lookup(store.alignments(schema))
            vals, idx = rerank_with_weak_scores(vals, idx, [args.image_id], chunk_ids, lookup,
                                                alpha=args.rerank)
            label = f"blend(a={args.rerank})"
        print(f"top-{args.k} chunks for {args.image_id}:")
        for rank, (v, j) in enumerate(zip(vals[0], idx[0]), 1):
            if j < 0:
                break
            print(f"  {rank:2d}. {chunk_ids[j]}  {label}={v:.4f}  {chunks[j]['text'][:70]!r}")
        return 0

    if args.text:
        # text -> images over the whole image corpus, always exact fp32 (K2)
        images = store.images(schema)
        img_ids, img_emb = store.embedding_matrix(schema, "images")
        engine = make_engine(config, args.device)
        q = engine.encode_text_batch([args.text])
        index = RetrievalIndex(img_emb, [i["manual_id"] for i in images],
                               [i.get("page") for i in images], device=args.device)
        vals, idx = index.search(q, k=args.k, global_search=True)
        print(f"top-{args.k} images for {args.text!r}:")
        for rank, (v, j) in enumerate(zip(vals[0], idx[0]), 1):
            if j < 0:
                break
            meta = images[j]
            print(f"  {rank:2d}. {img_ids[j]}  sim={v:.4f}  "
                  f"page={meta.get('page')} caption={meta.get('caption')!r}")
        return 0

    print("query requires --image-id or --text")
    return 1


if __name__ == "__main__":
    sys.exit(main())
