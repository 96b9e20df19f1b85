"""barbell_tpu — accelerator-native pattern-aware Nanopore barcode
demultiplexing.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
`rickbeeloo/barbell` CLI (annotate → inspect → filter → trim), built for
a GPU: the edit-distance search of barcode+flank constructs runs as
batched device kernels over dense padded read tensors; the surrounding
pipeline (pattern grammar, kit database, trimming, IO) runs on the host.

Stage contract (mirrors reference `src/kits/use_kit.rs:43-105`): stages
communicate through files — ``annotation.tsv`` → ``filtered.tsv`` →
per-label trimmed FASTQs — so every stage is independently restartable.
"""

__version__ = "0.1.0"

# Barcode window padding in bases, reference `src/lib.rs:10` (PADDING = 10).
PADDING = 10
