#!/bin/bash
# Run the ddlo container with the host's GPUs (reference: docker/run.sh).
# Arguments go to the `ddlo` entry point, e.g. docker/run.sh run --help
docker run -it --rm --gpus all \
           -v "$(pwd)":/data -w /data \
           ddlo "$@"
