"""Plain references written for this benchmark from the published layer and optimizer
equations (one module per model family, ``adamw`` for the optimizer); they import
nothing of the program under test, nor JAX, and take nothing the program made."""
