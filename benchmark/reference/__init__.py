"""The benchmark's plain reference: CGAtNet's forward, its loss, AdamW and
Adam, and the SVGP's ELBO, in plain PyTorch over a dict of f32 tensors,
with its own collate. It imports no kernel and nothing of the program:
what the program derives from the inputs (collated batches, the
normalisation, the inducing points) it works out again."""
