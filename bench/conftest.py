"""The benchmark's run outputs (``bench/out/``: caches, readings, an
unpacked copy of the tree) hold no tests of their own."""
collect_ignore = ["out"]
