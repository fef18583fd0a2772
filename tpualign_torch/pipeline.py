"""Pipeline orchestrator (the port's ``tpualign.pipeline``).

tpualign's five stages, with their completion checks, skip/force rules
and the operator's pause:

1. document processing: done iff the three JSONs exist, ``images/`` is
   not empty and the raw inputs' fingerprint matches the manifest's;
2. lexical filtering: done iff the filtered vocabulary exists;
3. store setup: done iff all four schemas exist;
4. embedding insertion: per schema, done iff it holds embeddings;
5. evaluation: ``metrics.json`` and three charts.

Stages 1-2 are host work, as in tpualign; stages 3-5 run on one device
(CUDA unless the caller asks for the CPU). Embeddings are computed once
and shared by the four schemas. ``run`` chains the five stages, from the
raw manuals to ``metrics.json``. ``ingest_cycle`` processes only new or
changed manuals and re-embeds; ``watch`` polls the input directory and
ingests on change, and ``notify_sync`` tells a running ``serve`` to pick
the delta up (``POST /sync``).
"""

from __future__ import annotations

import hashlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from tpualign_torch.config import PipelineConfig
from tpualign_torch.data.filtering import filter_lexical_components, load_exclude_terms
from tpualign_torch.data.processor import DocumentProcessor
from tpualign_torch.parallel.mesh import one_process, shard_devices
from tpualign_torch.store import SCHEMAS, EmbeddingStore
from tpualign_torch.utils.device import resolve_device
from tpualign_torch.utils.logging import get_logger
from tpualign_torch.weaksup import compute_alignments

log = get_logger("pipeline")

__all__ = ["Pipeline", "SCHEMA_FLAGS", "notify_sync"]

SCHEMA_FLAGS: Dict[str, tuple] = {
    # schema -> (use_lexical, use_positional)
    "vanilla_clip": (False, False),
    "clip_lexical": (True, False),
    "clip_positional": (False, True),
    "clip_combined": (True, True),
}



def notify_sync(base_url: str, timeout: float = 60.0,
                token: Optional[str] = None) -> Optional[dict]:
    """POST ``/sync`` to a running ``serve`` so that it picks up the store's
    delta without a rebuild; ``token`` is its ``SERVE_TOKEN``, when it needs
    one. A failure is logged and gives None: an ingest never fails because
    the daemon is down."""
    import urllib.request

    url = base_url.rstrip("/") + "/sync"
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    try:
        req = urllib.request.Request(url, b"{}", headers)
        with urllib.request.urlopen(req, timeout=timeout) as r:
            out = json.loads(r.read())
        log.info("serve sync: +%s -%s (corpus %s)", out.get("added"), out.get("removed"),
                 out.get("corpus_size"))
        return out
    except Exception as e:
        log.warning("serve sync against %s failed: %s", url, e)
        return None


class Pipeline:
    """The five stages over a config; stages 3-5 on ``device`` (CUDA by
    default; raises when it is absent unless ``device="cpu"``), or with the
    embedding engine and the Evaluator's index data-parallel over ``mesh``
    (whose first device then takes the place of ``device``; a mesh across
    processes raises, as the engine and the Evaluator do). ``engine``
    replaces the embedding engine (any object with ``embed_image_records``
    and ``embed_chunk_records``). ``nlp`` and ``lexical_fallback`` go to
    the ``DocumentProcessor`` of stage 1: ``"auto"`` loads spaCy for the
    configured language and, without it, the heuristic noun extractor."""

    def __init__(self, config: PipelineConfig, engine=None,
                 store: Optional[EmbeddingStore] = None,
                 device: str | torch.device = "cuda", nlp="auto",
                 lexical_fallback: str = "heuristic", mesh=None):
        self.config = config
        self.mesh = mesh
        devices = shard_devices(mesh)
        one_process(mesh, "Pipeline(mesh=)")
        self.device = resolve_device(device) if devices is None else devices[0]
        self._engine = engine
        self.store = store or EmbeddingStore(config.store.root,
                                             embed_dim=config.model.variant.embed_dim)
        self._nlp = nlp
        self._lexical_fallback = lexical_fallback
        out = Path(config.data.output_dir)
        self.image_metadata_file = out / "image_metadata.json"
        self.text_chunks_file = out / "text_chunks.json"
        self.lexical_file = out / "lexical_components.json"
        self.filtered_lexical_file = out / "filtered_lexical_components.json"
        self.images_dir = Path(config.data.images_dir)

    # -- lazily built embedding engine (building the towers is expensive) ----------

    @property
    def engine(self):
        if self._engine is None:
            from tpualign_torch.parallel.embed import EmbedEngine

            self._engine = EmbedEngine(
                self.config.model,
                batch_size=self.config.batch_size,
                seed=self.config.seed,
                preprocess=self.config.image_preprocess,
                preprocess_bucket=self.config.image_preprocess_bucket,
                text_buckets=self.config.text_buckets,
                device=self.device,
                mesh=self.mesh,
            )
        return self._engine

    # -- the step manifest: a fingerprint of the raw inputs, so that an
    # edited or added manual re-runs document processing without --force

    @property
    def _manifest_file(self) -> Path:
        return Path(self.config.data.output_dir) / ".tpualign_manifest.json"

    def _inputs_fingerprint(self) -> str:
        raw = Path(self.config.data.input_dir)
        h = hashlib.sha256()
        if raw.exists():
            for p in sorted(raw.glob("*")):
                st = p.stat()
                h.update(f"{p.name}:{st.st_size}:{st.st_mtime_ns}".encode())
        return h.hexdigest()

    def _read_manifest(self) -> dict:
        if self._manifest_file.exists():
            try:
                return json.loads(self._manifest_file.read_text())
            except (OSError, json.JSONDecodeError):
                return {}
        return {}

    def _record_step(self, step: str, **extra) -> None:
        manifest = self._read_manifest()
        manifest[step] = {"completed_at": time.time(), **extra}
        self._manifest_file.parent.mkdir(parents=True, exist_ok=True)
        self._manifest_file.write_text(json.dumps(manifest, indent=2))

    # -- completion checks ---------------------------------------------------------------

    def check_document_processing(self) -> bool:
        files_ok = (self.image_metadata_file.exists() and self.text_chunks_file.exists()
                    and self.lexical_file.exists() and self.images_dir.exists()
                    and any(self.images_dir.glob("*")))
        if not files_ok:
            return False
        recorded = self._read_manifest().get("document_processing", {})
        fingerprint = recorded.get("inputs_fingerprint")
        if fingerprint is not None and fingerprint != self._inputs_fingerprint():
            log.info("Raw inputs changed since last processing; re-running")
            return False
        return True

    def check_lexical_filtering(self) -> bool:
        return self.filtered_lexical_file.exists()

    def check_store_setup(self) -> bool:
        return all(self.store.schema_exists(s) for s in SCHEMAS)

    def check_embeddings_inserted(self, schema: str) -> bool:
        return self.store.has_embeddings(schema)

    # -- stages 1-2: host work -------------------------------------------------------------

    def step_document_processing(self, force: bool = False) -> None:
        """Stage 1. Exits (``SystemExit(1)``) when the input directory is
        missing or empty, or when processing produced no data."""
        if not force and self.check_document_processing():
            log.info("Document processing already completed. Skipping...")
            return
        raw = Path(self.config.data.input_dir)
        if not raw.exists() or not any(raw.glob("*")):
            log.error("No files found in %s", raw)
            raise SystemExit(1)
        proc = DocumentProcessor(self.config.data, nlp=self._nlp,
                                 lexical_fallback=self._lexical_fallback)
        summary = proc.process_all_documents()
        if summary["images"] == 0 and summary["chunks"] == 0:
            log.error("Document processing produced no data")
            raise SystemExit(1)
        self._record_step("document_processing",
                          inputs_fingerprint=self._inputs_fingerprint(), **summary)

    def step_lexical_filtering(self, force: bool = False, non_interactive: bool = False) -> None:
        """Stage 2: prints the top terms, then (unless ``non_interactive``)
        waits for the operator to edit the exclusion list and press Enter,
        or type ``skip`` to keep every term unfiltered."""
        if not force and self.check_lexical_filtering():
            log.info("Lexical components already filtered. Skipping...")
            return
        if not self.lexical_file.exists():
            log.error("Lexical components not found. Run document processing first.")
            raise SystemExit(1)

        with open(self.lexical_file) as f:
            lexical_data = json.load(f)
        print(f"\nFound {lexical_data['total_components']} unique lexical components")
        print("Top 20 most frequent terms:")
        for i, comp in enumerate(lexical_data["components"][:20], 1):
            print(f"  {i:2d}. {comp['term']:30s} (count: {comp['count']})")

        if not non_interactive:
            exclude_path = self.config.data.exclude_terms_file or "exclude_terms.txt"
            print(f"\nTo filter non-relevant terms, add them to {exclude_path} "
                  "(one per line), then press Enter to continue — or type 'skip' "
                  "to use all components.")
            try:
                response = input().strip().lower()
            except EOFError:
                response = ""
            if response == "skip":
                log.warning("Skipping lexical filtering. Using all components.")
                return

        exclude = load_exclude_terms(self.config.data.exclude_terms_file)
        filter_lexical_components(self.lexical_file, self.filtered_lexical_file, exclude)

    # -- incremental ingestion -----------------------------------------------------------

    def ingest_cycle(self, evaluate: bool = False) -> dict:
        """One incremental pass: process new or changed manuals (deduplicated
        by content hash), re-filter the vocabulary without a pause, re-embed
        the merged corpus (store upserts, so it is idempotent), and
        evaluate when asked. Returns the processor's summary, whose
        ``ingested`` is empty when nothing changed; a store left behind by
        an interrupted cycle is re-embedded even then."""
        proc = DocumentProcessor(self.config.data, nlp=self._nlp,
                                 lexical_fallback=self._lexical_fallback)
        summary = proc.process_incremental()
        if not summary.get("ingested"):
            if self._store_in_sync():
                return summary
            log.warning("Store out of sync with processed outputs (interrupted ingest?); "
                        "re-embedding")
        self._record_step("document_processing", inputs_fingerprint=self._inputs_fingerprint(),
                          **{k: v for k, v in summary.items()
                             if k in ("images", "chunks", "lexical_terms")})
        self.step_lexical_filtering(force=True, non_interactive=True)
        self.step_store_setup(force=False)
        self.step_insert_embeddings(force=True)
        if evaluate:
            self.step_evaluation()
        return summary

    def _store_in_sync(self) -> bool:
        """True when every schema's row counts match the processed JSONs
        (and when nothing is processed yet)."""
        try:
            images, chunks, _ = self._load_processed()
        except Exception:
            return True
        for schema in SCHEMAS:
            if not self.store.schema_exists(schema):
                return False
            counts = self.store.counts(schema)
            if counts["images"] != len(images) or counts["text_chunks"] != len(chunks):
                return False
        return True

    def watch(self, interval_seconds: float = 30.0, evaluate: bool = False,
              max_cycles: Optional[int] = None, notify: Optional[str] = None) -> None:
        """Poll the input directory and ingest on change (polling keeps it
        free of dependencies and safe on NFS). ``max_cycles`` bounds the
        loop; ``notify`` (a ``serve`` base URL) gets ``POST /sync`` after
        every cycle that ingested something. A failed cycle is logged and
        the loop goes on."""
        cycles = 0
        log.info("Watching %s every %.0fs (Ctrl-C to stop)", self.config.data.input_dir,
                 interval_seconds)
        while max_cycles is None or cycles < max_cycles:
            try:
                summary = self.ingest_cycle(evaluate=evaluate)
                if summary.get("ingested"):
                    log.info("Ingested: %s", ", ".join(summary["ingested"]))
                    if notify:
                        notify_sync(notify, token=self.config.serve_token)
            except KeyboardInterrupt:
                raise
            except Exception as e:
                log.error("Ingest cycle failed: %s", e)
            cycles += 1
            if max_cycles is None or cycles < max_cycles:
                time.sleep(interval_seconds)

    # -- stages 3-5 ------------------------------------------------------------------------

    def step_store_setup(self, force: bool = False) -> None:
        if not force and self.check_store_setup():
            log.info("Store schemas already set up. Skipping...")
            return
        self.store.setup(SCHEMAS, force=force)
        log.info("Store setup completed at %s", self.store.root)

    def _load_processed(self):
        with open(self.image_metadata_file) as f:
            images = json.load(f)
        with open(self.text_chunks_file) as f:
            chunks = json.load(f)
        lexical_terms: List[str] = []
        # the filtered vocabulary, else the unfiltered one
        src = (self.filtered_lexical_file if self.filtered_lexical_file.exists()
               else self.lexical_file)
        if src.exists():
            with open(src) as f:
                lexical_terms = [c["term"] for c in json.load(f).get("components", [])]
        return images, chunks, lexical_terms

    def step_insert_embeddings(self, force: bool = False,
                               schemas: Optional[Sequence[str]] = None) -> List[str]:
        """Embeds once and fills each schema that is not done (all with
        ``force``). A schema's failure is logged and the next one goes on,
        as in tpualign; returns the schemas that failed."""
        schemas = list(schemas or SCHEMAS)
        todo = [s for s in schemas if force or not self.check_embeddings_inserted(s)]
        for s in schemas:
            if s not in todo:
                log.info("%s already has embeddings. Skipping...", s)
        if not todo:
            return []

        images, chunks, lexical_terms = self._load_processed()

        # one embedding pass, shared by every schema
        log.info("Embedding %d images and %d chunks...", len(images), len(chunks))
        img_embs = self.engine.embed_image_records(images, self.images_dir)
        chunk_embs = self.engine.embed_chunk_records(chunks)

        failed = []
        for schema in todo:
            try:
                use_lex, use_pos = SCHEMA_FLAGS[schema]
                self.store.insert_images(schema, images, img_embs)
                self.store.insert_chunks(schema, chunks, chunk_embs)
                records = compute_alignments(images, chunks, lexical_terms, use_lex, use_pos,
                                             device=self.device)
                if records:
                    self.store.insert_alignments(schema, records)
                log.info("Populated %s: %d images, %d chunks, %d alignments",
                         schema, len(images), len(chunks), len(records))
            except Exception as e:  # go on with the next schema, as tpualign does
                log.error("Failed to insert embeddings into %s: %s", schema, e)
                failed.append(schema)
        self.store.save(todo)
        return failed

    def step_evaluation(self) -> Optional[dict]:
        """Writes ``metrics.json``, then the charts. Returns the metrics
        (without a schema whose evaluation failed), or None with a warning
        when the report failed. A failure of the charts (they need
        matplotlib) is a warning: ``metrics.json`` is written before them."""
        from tpualign_torch.evaluation import Evaluator

        out = self.config.eval_output_dir
        try:
            ev = Evaluator(self.store, output_dir=out, device=self.device, mesh=self.mesh)
            metrics = ev.print_metrics_report(list(SCHEMAS))
        except Exception as e:
            log.warning("Evaluation completed with warnings: %s", e)
            return None
        try:
            from tpualign_torch.evaluation import plots

            plots.plot_similarity_distributions(ev, list(SCHEMAS), out)
            plots.plot_top_k_comparison(ev, list(SCHEMAS), out)
            plots.plot_weak_supervision_scores(ev, out)
            log.info("Evaluation complete; results in %s/", out)
        except Exception as e:
            log.warning("Evaluation completed with warnings (no charts): %s", e)
        return metrics

    def unevaluated(self, metrics: Optional[dict]) -> List[str]:
        """The schemas of the store that ``metrics`` (what
        ``step_evaluation`` returned) holds no result for."""
        return [s for s in SCHEMAS if self.store.schema_exists(s) and s not in (metrics or {})]

    # -- run ---------------------------------------------------------------------------

    def run(self, skip_pdf: bool = False, skip_lexical: bool = False, skip_db: bool = False,
            skip_embeddings: bool = False, skip_eval: bool = False, force: bool = False,
            non_interactive: bool = False) -> List[str]:
        """The five stages in order, each skipped by its flag or when its
        completion check holds (all re-run with ``force``). A schema that
        fails to fill or to evaluate is logged and the run goes on, as in
        tpualign; returns the schemas that failed (empty on success)."""
        print("\n" + "=" * 80)
        print("MULTIMODAL ALIGNMENT PIPELINE (tpualign_torch)")
        print("=" * 80 + "\n")
        failed: List[str] = []
        try:
            if not skip_pdf:
                self.step_document_processing(force=force)
            else:
                log.info("Skipping document processing")
            if not skip_lexical:
                self.step_lexical_filtering(force=force, non_interactive=non_interactive)
            else:
                log.info("Skipping lexical filtering")
            if not skip_db:
                self.step_store_setup(force=force)
            else:
                log.info("Skipping store setup")
            if not skip_embeddings:
                failed += self.step_insert_embeddings(force=force)
            else:
                log.info("Skipping embedding insertion")
            if not skip_eval:
                failed += [s for s in self.unevaluated(self.step_evaluation())
                           if s not in failed]
            else:
                log.info("Skipping evaluation")
            print("\n" + "=" * 80)
            print("PIPELINE COMPLETE!")
            print("=" * 80)
        except KeyboardInterrupt:
            log.error("Pipeline interrupted by user")
            sys.exit(1)
        return failed
