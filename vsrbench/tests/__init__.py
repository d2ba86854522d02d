"""The benchmark's own tests (CPU, tiny shapes; the ones marked `cuda` need
a card): `python -m pytest vsrbench/tests` from the repo root."""
