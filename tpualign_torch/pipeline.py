"""Pipeline orchestrator (the port's ``tpualign.pipeline``), stages 3-5.

tpualign's five stages (3-5 with their completion checks and skip/force
rules):

1. document processing (the three JSONs and ``images/``);
2. lexical filtering (the filtered vocabulary);
3. store setup: done iff all four schemas exist;
4. embedding insertion: per schema, done iff it holds embeddings;
5. evaluation: ``metrics.json`` and three charts.

The port runs stages 3-5 (``setup-db``, ``embed``, ``evaluate``) over the
processed outputs of stages 1-2, on one device. Embeddings are computed
once and shared by the four schemas. Document extraction needs PDF
libraries, so stages 1-2, ``run`` and ingestion raise
``NotImplementedError``; ``python -m tpualign process``/``filter`` write
the processed directory in the same format.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from tpualign_torch.config import PipelineConfig
from tpualign_torch.store import SCHEMAS, EmbeddingStore
from tpualign_torch.utils.device import resolve_device
from tpualign_torch.utils.logging import get_logger
from tpualign_torch.weaksup import compute_alignments

log = get_logger("pipeline")

__all__ = ["Pipeline", "SCHEMA_FLAGS"]

SCHEMA_FLAGS: Dict[str, tuple] = {
    # schema -> (use_lexical, use_positional)
    "vanilla_clip": (False, False),
    "clip_lexical": (True, False),
    "clip_positional": (False, True),
    "clip_combined": (True, True),
}

_NOT_PORTED = ("not yet ported to tpualign_torch (ROADMAP §2.6, 'document processing, "
               "filtering and run'); run `python -m tpualign process` and `filter`, then "
               "`python -m tpualign_torch setup-db`, `embed` and `evaluate`")


class Pipeline:
    """Stages 3-5 over a config, on ``device`` (CUDA by default; raises
    when it is absent unless ``device="cpu"``). ``engine`` replaces the
    embedding engine (any object with ``embed_image_records`` and
    ``embed_chunk_records``)."""

    def __init__(self, config: PipelineConfig, engine=None,
                 store: Optional[EmbeddingStore] = None,
                 device: str | torch.device = "cuda"):
        self.config = config
        self.device = resolve_device(device)
        self._engine = engine
        self.store = store or EmbeddingStore(config.store.root,
                                             embed_dim=config.model.variant.embed_dim)
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
            )
        return self._engine

    # -- completion checks ---------------------------------------------------------------

    def check_store_setup(self) -> bool:
        return all(self.store.schema_exists(s) for s in SCHEMAS)

    def check_embeddings_inserted(self, schema: str) -> bool:
        return self.store.has_embeddings(schema)

    # -- stages 1-2, run and ingestion: not ported ----------------------------------------

    def step_document_processing(self, force: bool = False) -> None:
        raise NotImplementedError(f"document processing is {_NOT_PORTED}")

    def step_lexical_filtering(self, force: bool = False, non_interactive: bool = False) -> None:
        raise NotImplementedError(f"lexical filtering is {_NOT_PORTED}")

    def run(self, **_flags) -> None:
        raise NotImplementedError(f"Pipeline.run is {_NOT_PORTED}")

    def ingest_cycle(self, evaluate: bool = False) -> dict:
        raise NotImplementedError(f"incremental ingestion is {_NOT_PORTED}")

    def watch(self, *args, **kwargs) -> None:
        raise NotImplementedError(f"watch mode is {_NOT_PORTED}")

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
            ev = Evaluator(self.store, output_dir=out, device=self.device)
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
