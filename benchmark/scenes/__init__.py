"""The program's side of each scene kind: the scene built through the
port's public DSL from a table the benchmark made (``reference/<kind>.py``
makes the tables), and the port's leaves of each named table entry."""
