"""Numpy data helpers copied from the reference: row padding and the
synthetic expanded-rcv1 corpus."""
