"""The benchmark's plain references, one module per model family
(``<family>.py``), over the frozen plain models of ``plain/``. They import
neither the port nor JAX."""
