"""Learned models (beyond-reference model family).

The reference has no trained components — its pitch tracker is librosa's
pYIN (aegis_engine_core/worker.py:9-15).  This package adds a device-native
neural alternative: PitchNet, a small spectrum-input pitch/voicing network
trained on-device on synthetic guitar data, exposed to the engines as
``pitch_backend="neural"``.
"""
