"""Server layer (torch counterpart of presto_tpu/server/). Ported so far:
the static catalog store and connector-factory registry
(catalog_store.py) and the feedback knob (knobs.py). The coordinator,
workers, REST protocol and wire format are ROADMAP queue 1 item 9."""
