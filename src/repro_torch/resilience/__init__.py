"""Campaign resilience (port of ``repro.resilience``): the fault plan,
torn-tail repair of the JSONL stores, the campaign journal behind
``sweep run --resume``, and the supervised worker pool with per-task
deadlines.

Everything here is stdlib-only at import time."""
