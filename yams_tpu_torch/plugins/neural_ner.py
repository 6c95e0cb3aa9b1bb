"""Bundled neural-NER plugin (the reference's GLiNER plugin slot).

Exposes entity_extractor_v1 backed by embed/ner.py's NerModel (torch
label-conditioned span tagger). Configure via the plugin init config:

  {"model_path": "/path/to/ner.pkl",       # trained NerModel.save() blob
   "min_conf": 0.5,
   "use_bundled": True,                    # fall back to the shipped model
   "device": "cuda"}                       # the model's torch device

Without an explicit model_path the plugin loads the BUNDLED checkpoint
(plugins/data/ner_default.pkl — trained by scripts/train_ner_default.py on
a synthetic software-KB corpus: code identifiers + multiword proper names,
with capitalized-ordinary-word hard negatives). Set use_bundled=False to
get the reference GLiNER plugin's dormant-without-weights posture instead.

Port of yams_tpu/plugins/neural_ner.py (the bundled checkpoint is a copy
of the reference's). It departs from the reference only in the "device"
key of the init config (PluginManager sets it to its app's device; the
card by default) and in its description, which names torch.
"""

from __future__ import annotations

import pathlib

from .spec import IFACE_ENTITY_EXTRACTOR, PluginManifest

_BUNDLED = pathlib.Path(__file__).parent / "data" / "ner_default.pkl"


def yams_plugin() -> PluginManifest:
    state: dict = {"model": None, "min_conf": 0.5}

    class _Extractor:
        def extract_entities(self, text: str):
            if state["model"] is None:
                return []
            return state["model"].extract(text, min_conf=state["min_conf"])

    def init(config: dict) -> None:
        cfg = config or {}
        path = cfg.get("model_path")
        state["min_conf"] = float(cfg.get("min_conf", 0.5))
        if not path and cfg.get("use_bundled", True) and _BUNDLED.exists():
            path = _BUNDLED
        if path:
            from ..embed.ner import NerModel

            state["model"] = NerModel.load(path, device=cfg.get("device", "cuda"))

    def health() -> dict:
        if state["model"] is None:
            return {"status": "degraded", "reason": "no model loaded"}
        return {"status": "ok", "labels": list(state["model"].cfg.labels)}

    return PluginManifest(
        name="neural_ner",
        version="1.0",
        description="GLiNER-class neural NER (torch label-conditioned tagger)",
        interfaces={IFACE_ENTITY_EXTRACTOR: _Extractor()},
        init=init,
        health=health,
    )
