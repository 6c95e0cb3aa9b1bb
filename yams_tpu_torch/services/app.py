"""The application context's index reopening, as far as the port has it.

`restore_slot_map` is AppContext._restore_slot_map (yams_tpu/services/
app.py:248-261): after VectorIndex.load and LexicalIndex.load, the engine's
slot map is rebuilt from the metadata store."""

from __future__ import annotations


def restore_slot_map(db, engine) -> None:
    """Slot map persists as metadata key '__slot__' per document; a slot
    with no document is -1."""
    rows = db.execute(
        "SELECT document_id, value FROM metadata WHERE key='__slot__'"
    ).fetchall()
    pairs = sorted(((int(v), d) for d, v in rows))
    engine._doc_by_slot = []
    engine._slot_by_doc = {}
    for slot, doc_id in pairs:
        while len(engine._doc_by_slot) < slot:
            engine._doc_by_slot.append(-1)
        engine._doc_by_slot.append(doc_id)
        engine._slot_by_doc[doc_id] = slot
