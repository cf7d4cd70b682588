"""The DAB / DAB+ decode chains built on the decoders of ``ops``."""
