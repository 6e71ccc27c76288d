"""The plain reference that decides ``correct``.

NumPy only. It imports nothing of the program under test: it works out
each LocalMessage's recipients and each query's answer again from the
subscriptions and messages the benchmark generated, with frozen copies
of the broker's semantics (cube quantization, replication filter, the
query kinds' cube-sampled contract).
"""
