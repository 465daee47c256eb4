"""Models and samplers: dense GP log densities, NUTS, ChEES, diagnostics."""
