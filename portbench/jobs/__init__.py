"""The jobs that traffic mixes name: each module's ``build(ctx)`` returns
the job, which sets up the program, drives the window one call at a time,
keeps what the correctness check compares (its ``witness``) and runs the
plain reference over the same inputs. See ``base.Job``."""
