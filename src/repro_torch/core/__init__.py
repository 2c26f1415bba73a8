"""BRAVO locks: the host lock zoo (verbatim copies of ``repro.core``'s
framework-free modules) and the device registry over the shared
visible-readers table.  Import submodules directly; this package imports
nothing on its own."""
