"""The port's applications (``tpu2048/apps``): the service behind every
client, its HTTP server and single-page web UI, the terminal client
and the pygame viewer.  Their train, test and device-watch jobs run
on the CUDA card unless told otherwise."""
