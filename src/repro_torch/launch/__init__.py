"""Entry points of the port: the serving prefill (``steps``) and the
problem routes of the training CLI (``train``)."""
