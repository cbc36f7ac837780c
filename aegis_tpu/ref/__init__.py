"""CPU oracle: faithful NumPy implementations of every device kernel.

These mirror the reference's librosa-based compute path (SURVEY.md §3.1) and
serve as the correctness baseline for the device pipeline — parity tests require
note-event F1 >= 0.99 between `aegis_tpu.core` (device) and `aegis_tpu.ref`
(this package).
"""
