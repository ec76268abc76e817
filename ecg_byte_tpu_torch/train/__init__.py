"""Training.  Only the checkpoint role that serving reads is ported so far."""
