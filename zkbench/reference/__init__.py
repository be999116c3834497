"""The plain reference: the semantics the port must give, worked out
again in plain Python from the seeded op streams.  It imports nothing
of the port and takes nothing the port made; it reads the port's
outputs (the replies and read-backs the harness recorded) only to
judge them."""
