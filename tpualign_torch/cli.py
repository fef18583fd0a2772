"""Command-line interface: ``python -m tpualign_torch <command>``.

``serve``, ``query`` and ``index`` are tpualign's, with the same flags,
environment keys and output; they run on the GPU. The other subcommands of
``python -m tpualign`` (run, process, filter, setup-db, embed, evaluate,
check, train, ingest, watch, calibrate) are later slices of the port: they
print so and exit with 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

from tpualign_torch.config import load_config
from tpualign_torch.store import SCHEMAS

_NOT_PORTED = ("run", "process", "filter", "setup-db", "embed", "evaluate", "check", "train",
               "ingest", "watch", "calibrate")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--env-file", default=".env", help="env file with configuration")
    p.add_argument("--store-dir", default=None)
    p.add_argument("--model", default=None, help="CLIP model name (e.g. ViT-B-32)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu, where the kernels' plain versions run")


def _config_from(args):
    overrides = {}
    for attr, env in (("store_dir", "STORE_DIR"), ("model", "CLIP_MODEL"),
                      ("batch_size", "BATCH_SIZE")):
        v = getattr(args, attr, None)
        if v is not None:
            overrides[env] = str(v)
    return load_config(overrides, env_file=args.env_file)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tpualign_torch",
        description="tpualign on an NVIDIA GPU: index, serve and query an embedding store",
    )
    sub = parser.add_subparsers(dest="command", required=True)

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

    p_index = sub.add_parser(
        "index", help="build + persist the IVF retrieval index offline (the reference built "
                      "its ANN index at setup time)")
    _add_common(p_index)
    p_index.add_argument("--schema", default="vanilla_clip", choices=list(SCHEMAS))
    p_index.add_argument("--cache", default=None,
                         help="artifact path (default: IVF_CACHE from the config, else "
                              "<store>/<schema>.ivf.npz)")

    for name in _NOT_PORTED:
        sub.add_parser(name, help="not yet ported (python -m tpualign has it)")

    args = parser.parse_args(argv)
    if args.command in _NOT_PORTED:
        print(f"tpualign_torch {args.command}: not yet ported to the GPU package; "
              f"run `python -m tpualign {args.command}`")
        return 2
    if args.command == "serve":
        return _run_serve(args)
    if args.command == "index":
        return _run_index(args)
    return _run_query(args)


def _run_index(args) -> int:
    """Build (or load) the schema's IVF artifact and print one JSON line
    with its geometry, as ``tpualign index`` does."""
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
    print(json.dumps({"schema": args.schema, "index": kind, "cache": cache, "n": index.n,
                      "precision": index.precision, "n_lists": index.n_lists,
                      "n_probes": index.n_probes, "capacity": index.capacity,
                      "spill": index.spill,
                      "calibrated_target": getattr(index, "calibrated_target", None)}))
    return 0


def _run_serve(args) -> int:
    from tpualign_torch.serving.server import (
        _ServiceBox, build_service, make_engine, make_image_bytes_encoder, serve_schemas)
    from tpualign_torch.store import EmbeddingStore

    config = _config_from(args)
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
        engine = make_engine(config, args.device)
        encoder = engine.encode_text_batch
        img_encoder = make_image_bytes_encoder(engine)

    boxes = {}
    for schema in schemas:
        try:
            service = build_service(config, schema, encoder=encoder, image_encoder=img_encoder,
                                    text_tower=not args.no_text_tower, device=args.device)
        except ValueError as e:
            # configuration errors exit cleanly, not with a traceback
            print(f"error building {schema}: {e}")
            return 1
        boxes[schema] = _ServiceBox(service)
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
