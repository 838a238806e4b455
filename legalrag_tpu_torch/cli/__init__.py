"""The offline build CLIs of the port (counterparts of ``scripts/``):

- ``python -m legalrag_tpu_torch.cli.preprocess_law``: raw statute text ->
  ``processed/law_{lang}.jsonl``;
- ``python -m legalrag_tpu_torch.cli.build_index``: processed corpora ->
  per-language bundles, built on the card unless ``--device cpu``;
- ``python -m legalrag_tpu_torch.cli.build_graph``: processed corpora ->
  per-language law graphs;
- ``python -m legalrag_tpu_torch.cli.index_admin``: list, show and activate
  index versions.

Each has ``main(argv=None)``, so it runs in-process too. Their files are
the JAX scripts' files: a bundle built by either package loads in the
other.
"""
