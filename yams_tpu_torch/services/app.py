"""AppContext: constructs and owns every subsystem (ServiceManager analog).

Port of yams_tpu/services/app.py on the port's content store, engine and
indexes, on one torch device. It departs from the reference in these ways
only:

- `AppContext(config=None, device="cuda")` gives `device` to the
  ContentStore and the SearchEngine; the default is the card.
- `_load_indexes` reopens the vector index as `config.vector.dtype` (the
  reference reopens an int8 index as bf16), and quarantines the files only
  when they fail to parse. A torch or CUDA error while loading (a
  RuntimeError, an out-of-memory) propagates and leaves the files in place.
- The KG's entity side index is saved beside the vector index
  (`vectors/entities/`) and reopened with it; the reference rebuilds it only
  as the graph service indexes documents again, so after its restart the
  entity leg finds nothing until then.
- The sharded tier arms over `parallel.mesh.visible_devices(device)`:
  every card for a CUDA device, the one device for the CPU (a test stands
  several CPU devices in by patching that function). "on" with one device
  raises the reference's RuntimeError before anything opens (the
  reference raises it after opening the store). `self.sharded` says
  whether the mesh is armed, and the detailed stats name its devices.
- No JIT cache: the CUDA kernels are cached by `_build.py`. The
  YAMS_TPU_DEBUG_NANS tripwire is not ported; it prints one line saying so.
- `embedding.provider` in {mock, neural, hf} builds that provider (with
  `embedding.checkpoint` when set) on the AppContext's device.
"""

from __future__ import annotations

import json
import os
import pathlib
import pickle
import sys
import threading
import zipfile

import torch

from ..core.config import Config, load_config
from ..device import resolve_device
from ..metadata.db import Database
from ..metadata.kg import KnowledgeGraphStore
from ..metadata.repository import MetadataRepository
from ..metadata.tree import TreeBuilder
from ..parallel.mesh import visible_devices
from ..search.engine import SearchEngine
from ..storage.content_store import ContentStore

# the KG's entity side index, saved beside the vector index
ENTITIES = "entities"

# what a checkpoint that fails to parse raises; anything else propagates
UNREADABLE_CHECKPOINT = (zipfile.BadZipFile, EOFError, pickle.UnpicklingError,
                         json.JSONDecodeError, ValueError, KeyError)


class AppContext:
    def __init__(self, config: Config | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.config = config or load_config()
        # multi-device serving: "auto" and "on" arm the sharded tier over
        # every visible device of this kind; YAMS_VECTOR_SHARDED overrides
        # the config, as in the reference. Decided before anything opens, so
        # a refused "on" leaves no lock held.
        sharded_mode = str(
            os.environ.get("YAMS_VECTOR_SHARDED")
            or getattr(self.config.vector, "sharded", "auto")).lower()
        arm = False
        if sharded_mode in ("auto", "on"):
            arm = len(visible_devices(self.device)) > 1
            if not arm and sharded_mode == "on":
                raise RuntimeError(
                    "vector.sharded='on' but only one device is visible")
        self.config.data_dir.mkdir(parents=True, exist_ok=True)
        self._acquire_lock()
        if os.environ.get("YAMS_TPU_DEBUG_NANS"):
            print("warning: YAMS_TPU_DEBUG_NANS is not ported (no NaN tripwire "
                  "in the torch port)", file=sys.stderr)
        self.content_store = ContentStore(
            self.config.storage_dir,
            chunking=self.config.chunking,
            compression=self.config.compression,
            device=self.device,
        )
        # corruption check + salvage before first open (db_recovery parity)
        from ..metadata.recovery import detect_and_salvage

        self.salvage_report = detect_and_salvage(self.config.metadata_db)
        self.db = Database(self.config.metadata_db)
        self.metadata = MetadataRepository(self.db)
        self.kg = KnowledgeGraphStore(self.db)
        self.trees = TreeBuilder(self.db)
        provider = None
        if self.config.embedding.provider not in ("", "simeon"):
            from ..embed.provider import create_provider

            kw = {}
            if self.config.embedding.checkpoint:
                kw["checkpoint"] = self.config.embedding.checkpoint
            provider = create_provider(self.config.embedding.provider,
                                       device=self.device, **kw)
        else:
            # The stored corpus defines its embedding space: adopt the
            # registered simeon space on reopen so a default-config process
            # (daemon, script, CLI) never builds a mismatched engine over an
            # existing index (reference: space-identity guard,
            # simeon_embedding_backend.cpp — mixing spaces is refused there).
            persisted = self.metadata.latest_vector_model()
            if persisted is not None:
                _mid, _dim, space = persisted
                emb = self.config.embedding
                if space != emb.space_id and space.count("/") >= 3:
                    prof, d, s, seed = space.split("/")[:4]
                    try:
                        emb.profile = prof
                        emb.dim = int(d.lstrip("d"))
                        emb.sketch_dim = int(s.lstrip("s"))
                        emb.seed = int(seed.removeprefix("seed"), 16)
                        self.config.vector.dim = emb.dim
                    except ValueError:
                        pass  # foreign space string: keep configured values
        if str(self.config.vector.engine).startswith("pq"):
            # pq engines imply the PQ search tier (reference: engine select
            # in vector_types.h picks SimeonPqAdc the same way)
            scfg = getattr(self.config, "search", None)
            if scfg is not None:
                scfg.pq_tier_enabled = True
        self.search_engine = SearchEngine(
            config=getattr(self.config, "search", None),
            embedding=self.config.embedding,
            vector=self.config.vector,
            lexical=self.config.lexical,
            kg_store=self.kg,
            provider=provider,
            device=self.device,
        )
        self.metadata.register_vector_model(
            self.config.embedding.profile if provider is None
            else self.config.embedding.provider,
            self.search_engine.provider.dim,
            self.search_engine.provider.space_id,
        )
        self._lock = threading.RLock()
        scfg = getattr(self.config, "search", None)
        if scfg is not None and getattr(scfg, "tuner_enabled", False):
            from ..search.tuner import SearchTuner

            self.search_engine.tuner = SearchTuner(
                state_path=self.config.data_dir / "tuner.json")
        self._load_indexes()
        self.sharded = arm and self.search_engine.enable_sharding()

        # services (lazy circular-free wiring)
        from .document_service import DocumentService
        from .download_service import DownloadService
        from .graph_service import GraphService
        from .grep_service import GrepService
        from .indexing_service import IndexingService
        from .search_service import SearchService
        from .session_service import SessionService
        from .stats_service import StatsService
        from .symbol_service import SymbolService
        from .watch_service import WatchService

        self.documents = DocumentService(self)
        self.search = SearchService(self)
        self.indexing = IndexingService(self)
        self.grep = GrepService(self)
        self.graph = GraphService(self)
        self.sessions = SessionService(self)
        self.stats = StatsService(self)
        self.downloads = DownloadService(self)
        self.watch = WatchService(self)
        self.symbols = SymbolService(self)

    def _acquire_lock(self) -> None:
        """Advisory single-writer lock on the data dir. A second writer gets
        a loud warning (the supported pattern is one daemon owning the dir
        with CLI/MCP clients routing through its socket, as in the reference)."""
        import fcntl

        self.lock_contended = False
        try:
            self._lock_fh = open(self.config.data_dir / ".lock", "w")
            fcntl.flock(self._lock_fh, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            self.lock_contended = True
            print(
                f"warning: another process holds {self.config.data_dir} "
                "(a running daemon?). Concurrent writers can race on index "
                "files; prefer routing through the daemon socket.",
                file=sys.stderr,
            )

    # -- index persistence -----------------------------------------------------
    def _load_indexes(self) -> None:
        """Load persisted indexes; a checkpoint that fails to parse is
        QUARANTINED (renamed *.corrupt-<n>, kept for forensics) and recorded
        as an explicit event (`self.index_load_event`) rather than silently
        rebuilt (reference: vector_schema_migration.cpp rebuild-on-
        unmigratable + db_recovery's quarantine-then-rebuild flow). A device
        error is not a corrupt file: it propagates and the files stay."""
        from ..index.lexical_index import LexicalIndex
        from ..index.vector_index import VectorIndex

        vdir = self.config.vectors_dir
        se = self.search_engine
        self.index_load_event: dict | None = None
        try:
            if (vdir / "vectors.json").exists():
                # the dtype the engine took from config.vector.dtype
                se.vector_index = VectorIndex.load(
                    vdir, device_dtype=se.vector_index.device_dtype,
                    device=self.device)
            if (vdir / "lexical.pkl").exists():
                se.lexical_index = LexicalIndex.load(vdir, self.config.lexical)
            if (vdir / ENTITIES / "vectors.json").exists():
                se.entity_index = VectorIndex.load(
                    vdir / ENTITIES, device_dtype=se.entity_index.device_dtype,
                    device=self.device)
            self._restore_slot_map()
            se.ensure_pq()  # pq engine w/o sidecar yet
        except UNREADABLE_CHECKPOINT as e:
            quarantined: list[str] = []
            for name in ("vectors.npz", "vectors.json", "pq.npz",
                         "lexical.pkl", ENTITIES):
                p = vdir / name
                if not p.exists():
                    continue
                n = 0
                while (q := p.with_name(f"{name}.corrupt-{n}")).exists():
                    n += 1
                try:
                    p.rename(q)
                    quarantined.append(q.name)
                except OSError:
                    pass
            self.index_load_event = {
                "event": "index_rebuild_required",
                "error": f"{type(e).__name__}: {e}",
                "quarantined": quarantined,
            }
            print(
                f"warning: index checkpoint unreadable "
                f"({self.index_load_event['error']}); quarantined "
                f"{quarantined}; the indexes start empty", file=sys.stderr)
            # a partially-applied load must not leave mixed state behind
            se.vector_index = VectorIndex(
                dim=se.provider.dim, capacity=se.vector_index.capacity,
                block_rows=se.vector_index.block_rows,
                space_id=se.provider.space_id,
                device_dtype=se.vector_index.device_dtype, device=self.device)
            se.lexical_index = LexicalIndex(self.config.lexical)
            ent = se.entity_index
            se.entity_index = VectorIndex(
                dim=ent.dim, capacity=1024, block_rows=ent.block_rows,
                space_id=ent.space_id, device=self.device)
            se._doc_by_slot = []
            se._slot_by_doc = {}

    def _restore_slot_map(self) -> None:
        """Slot map persists as metadata key 'slot' per document."""
        rows = self.db.execute(
            "SELECT document_id, value FROM metadata WHERE key='__slot__'"
        ).fetchall()
        pairs = sorted(((int(v), d) for d, v in rows))
        eng = self.search_engine
        eng._doc_by_slot = []
        eng._slot_by_doc = {}
        for slot, doc_id in pairs:
            while len(eng._doc_by_slot) < slot:
                eng._doc_by_slot.append(-1)
            eng._doc_by_slot.append(doc_id)
            eng._slot_by_doc[doc_id] = slot

    def save_indexes(self) -> None:
        with self._lock:
            # pq engines (re)build codebooks on the persistence cadence
            # (reference: CheckpointManager + PQ staleness stamps)
            self.search_engine.ensure_pq()
            vdir = self.config.vectors_dir
            self.search_engine.vector_index.save(vdir)
            self.search_engine.lexical_index.save(vdir)
            self.search_engine.entity_index.save(vdir / ENTITIES)

    def checkpoint(self) -> None:
        """Persist indexes + WAL checkpoint (reference: CheckpointManager)."""
        self.save_indexes()
        if self.content_store.wal:
            self.content_store.wal.checkpoint()

    def close(self) -> None:
        try:
            self.save_indexes()
        except Exception:
            pass
        self.content_store.close()
        self.db.close()
        try:
            self._lock_fh.close()
        except Exception:
            pass

    def __enter__(self) -> "AppContext":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_app(data_dir: str | pathlib.Path | None = None,
             device: str | torch.device = "cuda") -> AppContext:
    return AppContext(load_config(data_dir=data_dir), device=device)
